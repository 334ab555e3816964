#!/usr/bin/env python3
"""Time the parts of one MoE layer's dispatch (``models/moe.py``) on the
card, at the token counts of ``chip_smoke.py``'s model paths.

    python3 tools/time_moe_dispatch.py

For each case (moonshot-v1-16b-a3b's and deepseek-v2-236b's MoE layer at a
forward of 1 x 4096 tokens, bf16), on a seeded routing that is balanced
and on one skewed towards a few experts (as random weights route: many
slots dropped): the slot positions as a running count in the reference's
token-major layout (``cumsum`` over dim 0 of a [T·k, E] one-hot) and in
the port's expert-major one (dim 1 of [E, T·k]), which must give the same
positions; the fill of the capacity buffers as the reference does it (an
``index_put_`` with ``accumulate=True``, a dropped slot adding zero at its
expert's position 0) and as the port does it (a copy, dropped slots to a
spare row), which must give the same buffers bit for bit; and the three
expert products over the buffers.
Milliseconds a call by CUDA events (chip_smoke.py's ``time_ms``). Every
line is JSON; the first names the card and its power limit. Exits non-zero
without CUDA or when the two layouts disagree.
"""

from __future__ import annotations

import itertools
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent

#: (name, T, top_k, E, D, F, capacity_factor)
CASES = [("moonshot-v1-16b-a3b", 4096, 6, 64, 2048, 1408, 1.25),
         ("deepseek-v2-236b", 4096, 6, 160, 5120, 1536, 1.25)]


def main() -> None:
    if not torch.cuda.is_available():
        print("time_moe_dispatch: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    smoke.emit({"card": smi, "torch": torch.__version__})
    for (name, T, k, E, D, Fd, cf), skew in itertools.product(CASES,
                                                              (0.0, 2.0)):
        g = torch.Generator(dev).manual_seed(0)
        bias = skew * torch.randn((E,), generator=g, device=dev)
        probs = torch.softmax(torch.randn((T, E), generator=g, device=dev)
                              + bias, dim=-1)
        idx = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :k]
        e_flat = idx.reshape(-1)
        cap = max(int(cf * T * k / E), 1)

        def token_major():
            flat = F.one_hot(e_flat, E)
            return (torch.cumsum(flat, dim=0) - flat).gather(
                1, e_flat[:, None])[:, 0]

        def expert_major():
            flat = (e_flat == torch.arange(E, device=dev)[:, None]).long()
            return (torch.cumsum(flat, dim=1) - flat).gather(
                0, e_flat[None, :])[0]

        same = torch.equal(token_major(), expert_major())
        pos = expert_major()
        keep = pos < cap
        pos = torch.where(keep, pos, 0)
        x = torch.randn((T * k, D), generator=g, device=dev).bfloat16()

        def scatter_add():
            buf = torch.zeros((E, cap, D), dtype=torch.bfloat16, device=dev)
            buf.index_put_((e_flat, pos), torch.where(keep[:, None], x, 0),
                           accumulate=True)
            return buf

        def copy():
            rows = torch.where(keep, e_flat * cap + pos, E * cap)
            buf = torch.zeros((E * cap + 1, D), dtype=torch.bfloat16,
                              device=dev)
            buf[rows] = x + 0.0
            return buf[:E * cap].view(E, cap, D)

        buf = scatter_add()
        same_buf = smoke.bit_equal(buf, copy())

        w = [torch.randn(s, generator=g, device=dev).bfloat16() * 0.02
             for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]

        def experts():
            gg = F.silu(torch.einsum("ecd,edf->ecf", buf, w[0]))
            u = torch.einsum("ecd,edf->ecf", buf, w[1])
            return torch.einsum("ecf,efd->ecd", gg * u, w[2])

        smoke.emit({"case": name, "skew": skew, "tokens": T, "top_k": k,
                    "experts": E, "capacity": cap, "positions_equal": same,
                    "buffers_bit_equal": same_buf,
                    "dropped_slots": int((~keep).sum()),
                    "positions_token_major_ms": smoke.time_ms(token_major),
                    "positions_expert_major_ms": smoke.time_ms(expert_major),
                    "fill_index_put_accumulate_ms": smoke.time_ms(scatter_add),
                    "fill_copy_ms": smoke.time_ms(copy),
                    "expert_products_ms": smoke.time_ms(experts)})
        smoke.check(same and same_buf, f"{name}: the two layouts give other "
                                       f"positions or buffers")


if __name__ == "__main__":
    main()
