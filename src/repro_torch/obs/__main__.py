import sys

from repro_torch.obs.cli import main

if __name__ == "__main__":      # not when a package walk imports it
    sys.exit(main())
