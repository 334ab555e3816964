"""Launch geometry checker: prove write disjointness, in-bounds tiling and
declared-only aliasing for every registered CUDA launch of the port.

Why static: the kernels are guarded dynamically (bit-exact or
tolerance-bound plain versions, held against them by ``chip_smoke.py``),
but those checks run only on the card and only see the races that happen
to fire there. A launch whose blocks overlap on an output is a race that a
given run may hide. This checker restates each launch declaratively and
enumerates its grid over the shapes the tests and ``chip_smoke.py`` use; it
runs on any host, the one check of a kernel that needs no card.

It is the JAX package's ``analysis/pallas_check.py``, copied and pinned by
the tests, with the registry walking ``repro_torch.kernels``. A CUDA launch
maps onto its terms so:

- a grid point is a CUDA block (``blockIdx``), the grid given in CUDA's
  (x, y, z) order and each ``index_map`` taking the block's (x, y, z);
- a block's declared output tile is every element its threads write, and
  an input tile every element they read;
- an output the kernel writes in place over one of its inputs is a
  declared alias (``aliases``, both decls naming one ``buffer``);
- an edge the kernel guards with a bounds test (the ragged last block) is
  a masked dim;
- a sequential loop inside a block is no grid axis at all, so
  ``reduction_axes`` (the TPU's sequential grid axes) stay unused.

The checks:

- **write disjointness** — output blocks touched by distinct grid points
  are pairwise disjoint unless every differing grid axis is declared a
  reduction axis;
- **in-bounds tiling** — every block of every ref lies inside its array,
  or the kernel declares an in-kernel mask for that (ref, dim) edge;
- **no undeclared aliasing** — refs sharing a buffer are only allowed as
  a declared alias pair, and a declared pair must tile identically (same
  array/block shape, index maps agreeing on every grid point) so the
  in-place update is well defined.

Registration: each kernel package ships a ``geometry.py`` module whose
provider is decorated with ``@register("<kernel>")`` and returns one
``KernelGeometry`` per concrete shape case, built from the same grid
helper its wrapper launches with. ``load_registry()`` imports every
``repro_torch.kernels.<pkg>.geometry`` module it can find.
"""

from __future__ import annotations

import dataclasses
import importlib
import itertools
import os
from typing import Callable, Mapping, Sequence

#: hard cap on concrete grid enumeration — registered cases use the tests'
#: and chip_smoke.py's shapes; hitting this means a spec registered a grid
#: too large to enumerate.
MAX_GRID_POINTS = 200_000


@dataclasses.dataclass(frozen=True)
class BlockDecl:
    """One tensor of a launch: its logical shape as the wrapper passes it,
    plus the tile one block reads or writes and where (``index_map``, in
    units of tiles).

    ``block_shape``/``index_map`` of ``None`` mean an unblocked ref (every
    block reads the whole array).
    ``masked_dims`` declares dims whose out-of-bounds tail is masked
    inside the kernel body.  ``buffer`` names the backing buffer; decls
    sharing a name alias each other and must be declared in
    ``KernelGeometry.aliases``.
    """

    name: str
    array_shape: tuple[int, ...]
    block_shape: tuple[int, ...] | None = None
    index_map: Callable[..., tuple[int, ...]] | None = None
    masked_dims: frozenset[int] = frozenset()
    buffer: str | None = None


@dataclasses.dataclass(frozen=True)
class KernelGeometry:
    """Declarative restatement of one concrete launch."""

    kernel: str                     # registry name, e.g. "flash_attention"
    module: str                     # module that makes the launch
    case: str                       # label for this shape set
    grid: tuple[int, ...]
    inputs: tuple[BlockDecl, ...]
    outputs: tuple[BlockDecl, ...]
    #: grid axes that are sequential accumulation axes: their partial
    #: results live in scratch and the output block is written once, so
    #: grid points differing only on these axes may map to the same
    #: output block.
    reduction_axes: frozenset[int] = frozenset()
    #: declared input→output aliases (outputs written in place).
    aliases: Mapping[int, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "aliases", dict(self.aliases))


@dataclasses.dataclass(frozen=True)
class Violation:
    kind: str       # "write-race" | "oob" | "alias" | "spec"
    kernel: str
    case: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.kind}] {self.kernel}/{self.case}: {self.detail}"


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], Sequence[KernelGeometry]]] = {}


def register(name: str):
    """Decorator: register a zero-arg provider returning the kernel's
    concrete ``KernelGeometry`` cases."""

    def deco(fn: Callable[[], Sequence[KernelGeometry]]):
        if name in _REGISTRY and _REGISTRY[name] is not fn:
            raise ValueError(f"kernel {name!r} registered twice")
        _REGISTRY[name] = fn
        return fn

    return deco


def load_registry() -> dict[str, Callable[[], Sequence[KernelGeometry]]]:
    """Import every ``repro_torch.kernels.<pkg>.geometry`` module and return
    the populated registry. Discovery walks the package path, so a kernel
    package without ``__init__.py`` is found too; the analysis fixtures live
    outside ``kernels/`` and are never picked up.
    """
    import repro_torch.kernels as kernels_pkg

    for root in kernels_pkg.__path__:
        for name in sorted(os.listdir(root)):
            if not os.path.isfile(os.path.join(root, name, "geometry.py")):
                continue
            importlib.import_module(f"repro_torch.kernels.{name}.geometry")
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _grid_points(grid: tuple[int, ...]):
    total = 1
    for g in grid:
        total *= g
    if total > MAX_GRID_POINTS:
        raise ValueError(
            f"grid {grid} has {total} points > MAX_GRID_POINTS "
            f"({MAX_GRID_POINTS}); register a test-sized case"
        )
    return itertools.product(*(range(g) for g in grid))


def _block_index(decl: BlockDecl, point: tuple[int, ...]) -> tuple[int, ...]:
    if decl.index_map is None:
        return (0,) * len(decl.array_shape)
    idx = tuple(int(i) for i in decl.index_map(*point))
    if len(idx) != len(decl.block_shape or decl.array_shape):
        raise ValueError(
            f"{decl.name}: index_map arity {len(idx)} != block rank"
        )
    return idx


def _check_spec(g: KernelGeometry) -> list[Violation]:
    """Structural sanity of the declaration itself."""
    out = []
    for decl in (*g.inputs, *g.outputs):
        if decl.block_shape is not None and (
            len(decl.block_shape) != len(decl.array_shape)
        ):
            out.append(Violation(
                "spec", g.kernel, g.case,
                f"{decl.name}: block rank {len(decl.block_shape)} != "
                f"array rank {len(decl.array_shape)}",
            ))
    for i_idx, o_idx in g.aliases.items():
        if not (0 <= i_idx < len(g.inputs) and 0 <= o_idx < len(g.outputs)):
            out.append(Violation(
                "spec", g.kernel, g.case,
                f"alias {i_idx}->{o_idx} out of range",
            ))
    return out


def _check_oob(g: KernelGeometry) -> list[Violation]:
    out = []
    for decl in (*g.inputs, *g.outputs):
        if decl.block_shape is None:
            continue
        seen: set[tuple[int, ...]] = set()
        for p in _grid_points(g.grid):
            idx = _block_index(decl, p)
            if idx in seen:
                continue
            seen.add(idx)
            for d, (i, b, n) in enumerate(
                zip(idx, decl.block_shape, decl.array_shape)
            ):
                if i < 0 or i * b + b > n:
                    if d in decl.masked_dims:
                        continue
                    out.append(Violation(
                        "oob", g.kernel, g.case,
                        f"{decl.name}: block index {idx} at grid point {p} "
                        f"spans [{i * b}, {i * b + b}) on dim {d} of an "
                        f"array of extent {n} with no declared mask",
                    ))
                    break
    return out


def _check_write_race(g: KernelGeometry) -> list[Violation]:
    out = []
    red = g.reduction_axes
    for decl in g.outputs:
        groups: dict[tuple[int, ...], set[tuple[int, ...]]] = {}
        for p in _grid_points(g.grid):
            idx = _block_index(decl, p)
            key = tuple(c for a, c in enumerate(p) if a not in red)
            groups.setdefault(idx, set()).add(key)
        for idx, keys in groups.items():
            if len(keys) > 1:
                a, b = sorted(keys)[:2]
                out.append(Violation(
                    "write-race", g.kernel, g.case,
                    f"{decl.name}: output block {idx} is written by "
                    f"{len(keys)} grid points that differ on "
                    f"non-reduction axes (e.g. {a} vs {b}); distinct "
                    f"grid points must write disjoint output blocks",
                ))
    return out


def _check_alias(g: KernelGeometry) -> list[Violation]:
    out = []
    declared = {(i, o) for i, o in g.aliases.items()}
    # undeclared sharing: any input buffer that also backs an output
    for ii, i_decl in enumerate(g.inputs):
        if i_decl.buffer is None:
            continue
        for oi, o_decl in enumerate(g.outputs):
            if o_decl.buffer != i_decl.buffer:
                continue
            if (ii, oi) not in declared:
                out.append(Violation(
                    "alias", g.kernel, g.case,
                    f"input {i_decl.name} aliases output {o_decl.name} "
                    f"(buffer {i_decl.buffer!r}) without a declared "
                    f"input_output_alias",
                ))
    # declared aliases must tile identically
    for ii, oi in declared:
        if not (0 <= ii < len(g.inputs) and 0 <= oi < len(g.outputs)):
            continue  # reported by _check_spec
        i_decl, o_decl = g.inputs[ii], g.outputs[oi]
        if (i_decl.array_shape != o_decl.array_shape
                or i_decl.block_shape != o_decl.block_shape):
            out.append(Violation(
                "alias", g.kernel, g.case,
                f"declared alias {i_decl.name}->{o_decl.name} has "
                f"mismatched array/block shapes",
            ))
            continue
        for p in _grid_points(g.grid):
            if _block_index(i_decl, p) != _block_index(o_decl, p):
                out.append(Violation(
                    "alias", g.kernel, g.case,
                    f"declared alias {i_decl.name}->{o_decl.name}: index "
                    f"maps disagree at grid point {p} — the in-place "
                    f"update would read and write different tiles",
                ))
                break
    return out


def check_geometry(g: KernelGeometry) -> list[Violation]:
    v = _check_spec(g)
    if v:
        return v  # structural errors make the other checks meaningless
    return _check_oob(g) + _check_write_race(g) + _check_alias(g)


def check_all(
    providers: Mapping[str, Callable[[], Sequence[KernelGeometry]]] | None
    = None,
) -> dict:
    """Run every registered kernel's cases; return a JSON-able report."""
    if providers is None:
        providers = load_registry()
    kernels = {}
    violations: list[Violation] = []
    for name in sorted(providers):
        cases = list(providers[name]())
        n_points = 0
        case_names = []
        for g in cases:
            pts = 1
            for axis in g.grid:
                pts *= axis
            n_points += pts
            case_names.append(g.case)
            violations.extend(check_geometry(g))
        kernels[name] = {
            "cases": case_names,
            "grid_points_checked": n_points,
            "violations": [
                str(v) for v in violations if v.kernel == name
            ],
        }
    return {
        "ok": not violations,
        "n_kernels": len(kernels),
        "n_violations": len(violations),
        "kernels": kernels,
        "violations": [dataclasses.asdict(v) for v in violations],
    }
