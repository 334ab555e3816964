"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``BENCHMARK.json`` at the root of the repository names the cells; this
package runs one cell once and prints one JSON line:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name ``BENCHMARK.json`` gives:

    configs/<config>.json        the configuration as it is run
    traffic/<mix>.json           a traffic mix; names its driver
    drivers/<driver>.py          set-up, the measured window, the check
    metrics/<metric>.py          a per-layer metric's reader
    counts/<kernel>.py           operations and bytes a kernel needs
    reference/<family>.py        the plain reference the check uses

Nothing here imports ``jax`` or the JAX package, and ``reference/`` and
``counts/`` import nothing of the program.
"""
