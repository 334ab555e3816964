"""Dispatching wrapper for decode attention — the single source of the
backend policy; ``models/layers.py::attention_decode`` sends every decode
step of a CUDA tensor through here.

Unlike the JAX package's dispatcher, there is no fallback for a cache
length that is not a multiple of the block: the CUDA kernel visits only the
visible keys and masks its own ragged edge, at any S and any window.
"""

from __future__ import annotations

from repro_torch import spmd
from repro_torch.kernels.flash_decode.flash_decode import (
    flash_decode,
    flash_decode_combine,
    flash_decode_partials,
)
from repro_torch.kernels.flash_decode.ref import (
    decode_attention_ref,
    decode_combine_ref,
    decode_partials_ref,
)


def decode_attention_op(q, k_cache, v_cache, pos, *, softcap=0.0, window=0,
                        backend: str = "auto"):
    """q: [B,H,hd]; k_cache, v_cache: [B,S,K,hd]; pos: [B] int32
    -> [B,H,hd].

    backend: "auto" -> the CUDA kernel for CUDA tensors, the plain PyTorch
    version for CPU tensors; "kernel" -> the CUDA kernel (raises on CPU
    tensors: there is no interpret mode); "ref" -> the plain version on any
    device. A kernel that fails to build or launch raises; nothing falls
    back to the plain version.

    DTensors (a model on a mesh) run on their local shards through
    ``spmd.attend``: batch rows or q heads. A cache sharded on its
    sequence takes ``_on_sequence_shards``: each rank's split pass over
    its slice, the partials gathered, one combine.

    Launches are counted in ``flash_decode.launches``.
    """
    if spmd.is_dtensor(q):
        if spmd.Shard(1) in k_cache.placements:
            return _on_sequence_shards(q, k_cache, v_cache, pos, softcap,
                                       window, backend)

        # local_map: the kernel reads raw pointers, so a DTensor never
        # reaches it; the work of a batch row or a q head is local
        def core(ql, kl, vl, pl, _):
            return decode_attention_op(ql, kl.contiguous(), vl.contiguous(),
                                       pl, softcap=softcap, window=window,
                                       backend=backend)

        return spmd.attend(core, q, k_cache, v_cache, pos, q_heads=1,
                           kv_heads=2)
    if backend == "auto":
        backend = "kernel" if q.is_cuda else "ref"
    if backend == "kernel":
        return flash_decode(q, k_cache, v_cache, pos, softcap=softcap,
                            window=window)
    if backend != "ref":
        raise ValueError(f"unknown decode attention backend: {backend!r}")
    return decode_attention_ref(q, k_cache, v_cache, pos, softcap=softcap,
                                window=window)


def _on_sequence_shards(q, k_cache, v_cache, pos, softcap, window, backend):
    """Decode attention of DTensors whose cache [B,S,K,hd] is sharded on S
    (over one or more mesh dims), through ``spmd.local``: each rank runs
    the split pass over its slice of the cache, at its own positions
    (``pos`` less the slice's first), which gives the partials of its
    chunks; the partials are all-gathered over the mesh dims that shard S,
    the minor one first, so that the chunks stand in the order of the
    whole cache; one combine pass merges them, as it merges one rank's.
    The batch rows and kv heads a rank holds stay local, its q heads
    follow its kv heads, and the output is q [B,H,hd] placed so: what the
    split pass reads is local to a slice, the combine is not."""
    mesh, q = k_cache.device_mesh, spmd.settle(q)
    kv_pl = k_cache.placements
    if spmd.Shard(3) in kv_pl or v_cache.placements != kv_pl:
        raise NotImplementedError(f"decode attention with the caches placed "
                                  f"{kv_pl}, {v_cache.placements}")
    seq = [i for i, p in enumerate(kv_pl) if p == spmd.Shard(1)]
    n = 1
    for i in seq:
        n *= mesh.size(i)
    if k_cache.shape[1] % n:
        raise ValueError(f"a cache of {k_cache.shape[1]} positions cut into "
                         f"{n} uneven slices")
    s0 = spmd.offset(k_cache, 1)
    groups = [mesh.get_group(i) for i in reversed(seq)]
    if backend == "auto":
        backend = "kernel" if q.is_cuda else "ref"
    if backend not in ("kernel", "ref"):
        raise ValueError(f"unknown decode attention backend: {backend!r}")
    partials, combine = ((flash_decode_partials, flash_decode_combine)
                         if backend == "kernel" else
                         (decode_partials_ref, decode_combine_ref))

    def fn(ql, kl, vl, pl):
        ml, acc = partials(ql, kl, vl, pl - s0, softcap=softcap,
                           window=window)
        for g in groups:
            ml, acc = spmd.gather(ml, 2, g), spmd.gather(acc, 2, g)
        return combine(ml.contiguous(), acc.contiguous(), ql.dtype)

    q_pl = spmd.follow(kv_pl, {0: 0, 2: 1})
    return spmd.local(fn, mesh, (q, k_cache, v_cache, pos),
                      (q_pl, kv_pl, kv_pl, spmd.follow(kv_pl, {0: 0})),
                      q_pl)
