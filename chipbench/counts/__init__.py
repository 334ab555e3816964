"""Operations and bytes a kernel needs, computed from its shapes: each
input byte read once, each output byte written once (the reads and
writes of the work these inputs need, whatever the kernel re-reads)."""
