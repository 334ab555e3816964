"""One launch of the fused placement kernel (``kernels/placement``): an
LP placement attempt for every replica of the fleet.

Windows are f32 ``t1``, f32 ``t2`` and a bool ``valid``: 9 bytes. Each
configuration's list holds ``list_tracks[c]`` tracks of ``windows``
windows; the kernel's input pads every list to the largest, and a padded
track is never valid, so it is not counted. A launch reads the queried
lists of every replica (the 2-core and the 4-core configuration's list
of every device) and its per-replica inputs (``min_dur`` of each
configuration, ``q1`` and ``dl`` of each device, ``src``, ``do``), and
writes its per-replica outputs (``ok``, ``sel``, ``start``, ``dur``,
``use4``, ``n_dropped``). A replica whose attempt commits also reads the
HP list of the chosen device and writes every list of that device back
(the fan-out commit). The arithmetic is a few compares and adds a window
and does not bound the launch.
"""

WINDOW_BYTES = 4 + 4 + 1
HP, LP2, LP4 = 0, 1, 2
QUERIED = (LP2, LP4)


def launch_bytes(replicas, devices, list_tracks, windows, committed):
    """Bytes one launch needs; ``committed`` replicas commit."""
    configs = len(list_tracks)
    queried = sum(list_tracks[c] for c in QUERIED) * windows * WINDOW_BYTES
    every = sum(list_tracks) * windows * WINDOW_BYTES
    read = (replicas * devices * queried
            + committed * list_tracks[HP] * windows * WINDOW_BYTES
            + replicas * (configs * 4 + 2 * devices * 4 + 4 + 1))
    written = committed * every + replicas * (1 + 4 + 4 + 4 + 1 + 4)
    return read + written


def launch_ops(replicas, devices, list_tracks, windows, committed):
    """f32 operations of one launch: ~5 a queried window, ~14 a
    committed one."""
    queried = sum(list_tracks[c] for c in QUERIED) * windows
    return (replicas * devices * queried * 5
            + committed * sum(list_tracks) * windows * 14)
