"""An offline prefill pool on the port's ``Model.forward``: every prompt of
the list is waiting when the window opens, and each step runs one batch.

The configuration names the port's config module (``port.module``),
which keys of the published configuration set which of its fields
(``port.fields``), the plain reference (``reference/<reference>.py``)
and the operation counts (``counts/<count>.py``). The run builds the
port's ``Model`` on ``meta`` and loads the benchmark's weights into it
(``load_state_dict``, assigned, no copy), so the timed path is the
port's normal one: its matmuls, its norms and rope, and its attention
kernel on the card.

Set-up draws every weight from ``--seed`` on the device, a few calls of
``normal_`` over one buffer in the configuration's dtype (the
reference's ``weight_specs`` give each weight's spread), and the
prompts: the traffic's lengths (every block of ``block`` prompts holds
the log-normal's stratum midpoints, rounded and clipped, in an order
drawn from the seed) and token ids uniform over the vocabulary. It
warms up one step of each shape the schedule uses.

The schedule (``Schedule``): the list is a queue, cycled (prompt id
``k`` is the list's prompt ``k % n``). A step takes the oldest waiting
prompt and the next waiting prompts of its length, as many as fit
``step_tokens``, so every step of a length has one shape and no padding.
The window runs steps in turn, each ``Model.forward`` under
``torch.inference_mode()`` on a [B, S] batch, keeps each prompt's
last-position logits (the first token's) and synchronizes; once
``--seconds`` have passed no step is started.

The check, once the window has closed and the model is freed: the
last-position logits that the timed steps produced for a sample of
prompts (the first and the last row of the step that holds the list's
first prompt of the longest length, and of ``sample_random`` more of
the first ``sample_steps`` steps), against the plain reference in
float32 on the same weights and tokens; and that every sampled prompt
was sent. The limits are the configuration's (``check``).

``program="control"`` puts the reference in the program's place in
float8_e4m3fn projections (the step below bfloat16), on the sampled
prompts. With ``--trace 1`` the profiler records the steps
``trace_steps`` of the window, bounded by synchronizes.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
import sys
import time
from statistics import NormalDist

import numpy as np
import torch

from chipbench.trace import TraceSlice

#: elements a call of ``normal_`` draws at most
_CHUNK = 1 << 30


@dataclasses.dataclass
class Outcome:
    """What a run measured and checked; the harness prints it."""

    e2e: dict
    checks: dict            # name -> (value, limit)
    attempted: int
    failed: int
    memory_peak_bytes: int
    context: dict | None = None   # what the per-layer readers read
    trace: dict | None = None


def prompt_lengths(traffic: dict, seed: int) -> np.ndarray:
    """The list's lengths: blocks of the same stratum midpoints of the
    log-normal, each block in an order drawn from the seed."""
    B, m = traffic["block"], traffic["multiple"]
    block = []
    for i in range(B):
        z = NormalDist().inv_cdf((i + 0.5) / B)
        n = traffic["median_tokens"] * math.exp(traffic["sigma"] * z)
        block.append(min(max(m * round(n / m), traffic["min_tokens"]),
                         traffic["max_tokens"]))
    rng = np.random.default_rng([seed, 1])
    return np.concatenate([rng.permutation(block)
                           for _ in range(traffic["prompts"] // B)])


class Schedule:
    """The pool's steps over the cycled list: ``next()`` gives ``(S,
    ids)``, the oldest waiting prompt and the next waiting ones of its
    length S, ``step_tokens // S`` of them."""

    def __init__(self, lengths: np.ndarray, step_tokens: int):
        self.n, self.budget = len(lengths), step_tokens
        self.at = {int(S): np.flatnonzero(lengths == S)
                   for S in np.unique(lengths)}
        self.served = dict.fromkeys(self.at, 0)
        if step_tokens < max(self.at):
            raise ValueError("a step cannot hold the longest prompt")

    def _id(self, S: int, k: int) -> int:
        """The id of the k-th prompt of length S in the cycled list."""
        c, r = divmod(k, len(self.at[S]))
        return c * self.n + int(self.at[S][r])

    def shapes(self) -> list[tuple[int, int]]:
        """``(B, S)`` of every step the schedule makes."""
        return [(self.budget // S, S) for S in self.at]

    def __iter__(self):
        return self

    def __next__(self) -> tuple[int, list[int]]:
        S = min(self.at, key=lambda s: self._id(s, self.served[s]))
        k = self.served[S]
        self.served[S] += self.budget // S
        return S, [self._id(S, k + j) for j in range(self.budget // S)]


def sample(lengths: np.ndarray, traffic: dict, seed: int) -> set[int]:
    """The compared prompts' ids: the first and the last row of the step
    that holds the list's first prompt of the longest length, and of
    ``sample_random`` steps drawn from the first ``sample_steps``."""
    longest = int(np.argmax(lengths))
    steps = []
    for n, (S, ids) in enumerate(Schedule(lengths, traffic["step_tokens"])):
        steps.append(ids)
        if n + 1 >= traffic["sample_steps"] and any(
                longest in s for s in steps):
            break
    rng = np.random.default_rng([seed, 2])
    at_longest = next(n for n, s in enumerate(steps) if longest in s)
    others = [n for n in range(traffic["sample_steps"]) if n != at_longest]
    picked = [at_longest, *(int(n) for n in rng.choice(
        others, traffic["sample_random"], replace=False))]
    return {i for n in picked for i in (steps[n][0], steps[n][-1])}


def make_weights(specs, dtype, device, gen) -> dict:
    """name -> a view of one buffer, drawn from N(0, std^2): the weights
    of one std lie side by side and are drawn in calls of at most
    ``_CHUNK`` elements."""
    specs = sorted(specs, key=lambda s: s[2])
    total = sum(math.prod(shape) for _, shape, _ in specs)
    buf = torch.empty(total, dtype=dtype, device=device)
    out, at, start = {}, 0, 0
    for j, (name, shape, std) in enumerate(specs):
        n = math.prod(shape)
        out[name] = buf[at:at + n].view(shape)
        at += n
        if j + 1 == len(specs) or specs[j + 1][2] != std:
            for a in range(start, at, _CHUNK):
                buf[a:min(a + _CHUNK, at)].normal_(0.0, std, generator=gen)
            start = at
    return out


def inputs(config: dict, traffic: dict, ref, seed: int, device):
    """What the seed makes: the weights (name -> tensor), the prompts'
    lengths, ``tokens(k)`` (prompt id k's ids on the device), ``batch(S,
    ids)`` (the [B, S] ids of one step) and the sampled ids."""
    gen = torch.Generator(device).manual_seed(seed)
    weights = make_weights(ref.weight_specs(config),
                           getattr(torch, config["torch_dtype"]), device, gen)
    lengths = prompt_lengths(traffic, seed)
    ids = torch.randint(config["vocab_size"], (int(lengths.sum()),),
                        generator=gen, device=device)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    n = len(lengths)
    ar = torch.arange(int(lengths.max()), device=device)

    def tokens(k):
        i = k % n
        return ids[starts[i]:starts[i + 1]]

    def batch(S, ks):
        at = torch.tensor([int(starts[k % n]) for k in ks], device=device)
        return ids[at[:, None] + ar[:S]]

    return weights, lengths, tokens, batch, sample(lengths, traffic, seed)


def port_config(config: dict):
    """The port's config module's ``CONFIG`` with the fields that the
    published configuration sets, as ``port.fields`` maps them."""
    port = config["port"]
    base = importlib.import_module(
        f"repro_torch.configs.{port['module']}").CONFIG
    return dataclasses.replace(base, **{
        field: config[key] for field, key in port["fields"].items()})


def run(config: dict, traffic: dict, *, seed: int, seconds: float,
        trace: bool, device, t_start: float, program=None) -> Outcome:
    """One run of the cell. ``program`` None runs the port; ``"control"``
    puts the reference in its place, its projections in float8."""
    from repro_torch.models.transformer import Model

    device = torch.device(device)
    cuda = device.type == "cuda"
    ref = importlib.import_module(f"chipbench.reference.{config['reference']}")
    cfg = port_config(config)
    phases = {"imports": time.perf_counter() - t_start}

    # -- set-up: weights, prompts, the model, a warm-up of every shape ----
    weights, lengths, tokens, batch, sampled = inputs(
        config, traffic, ref, seed, device)
    phases["inputs"] = time.perf_counter() - t_start
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    schedule = Schedule(lengths, traffic["step_tokens"])
    if program is None:
        model = Model(cfg, device="meta")
        model.load_state_dict(weights, strict=True, assign=True)

        def step(S, ks):
            return model({"tokens": batch(S, ks)})[0][:, -1]

        with torch.inference_mode():
            for B, S in schedule.shapes():
                first = int(np.flatnonzero(lengths == S)[0])
                step(S, [first] * B)
    elif program == "control":
        def step(S, ks):
            last = torch.tensor([S - 1], device=device)
            return torch.cat([ref.forward_rows(
                config, weights, tokens(k), last, precision="float8_e4m3fn")
                for k in ks])

        # every sampled prompt, whatever the time
        schedule = iter([(int(lengths[k % len(lengths)]), [k])
                         for k in sorted(sampled)])
        seconds = math.inf
    else:
        raise ValueError(f"no program {program!r}")
    sync()
    phases["warmed"] = time.perf_counter() - t_start
    print("set-up s since start: " + ", ".join(
        f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr)

    # -- the window: steps in turn, each synchronized ---------------------
    first_traced, end_traced = traffic["trace_steps"] if trace else (0, 0)
    traced = TraceSlice() if trace else None
    kept, steps = {}, []
    done_tokens = sent = 0
    slice_s = 0.0     # the traced steps' time, the trace's reduction in it
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    with torch.inference_mode():
        for n, (S, ks) in enumerate(schedule):
            if time.perf_counter() - t0 >= seconds and n >= end_traced:
                break
            if traced and n == first_traced:
                t_slice = time.perf_counter()
                traced.start()
            last = step(S, ks)
            for j, k in enumerate(ks):
                if k in sampled:
                    kept[k] = last[j].clone()
            sync()
            if traced and n + 1 == end_traced:
                traced.stop()
                slice_s = time.perf_counter() - t_slice
            steps.append((len(ks), S))
            done_tokens += len(ks) * S
            sent += len(ks)
    window_s = time.perf_counter() - t0
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    print(f"window: {len(steps)} steps, {sent} prompts, {done_tokens} "
          f"tokens in {window_s:.3f} s", file=sys.stderr)
    if program is None:
        del model, step
        if cuda:
            torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    checks, failed = _check(config, ref, weights, tokens, sampled, kept)
    outcome = Outcome(
        e2e={"setup_s": setup_s,
             "prefill_tokens_per_s": done_tokens / window_s},
        checks=checks, attempted=sent, failed=failed,
        memory_peak_bytes=int(memory_peak))
    if trace:
        if traced.summary is None:
            raise RuntimeError("the traced steps never ran")
        rest = steps[:first_traced] + steps[end_traced:]
        rest_tokens = sum(B * S for B, S in rest)
        print(f"traced slice: {traced.summary['wall_s']:.3f} s profiled, "
              f"{slice_s:.3f} s with its reduction, "
              f"{(done_tokens - rest_tokens) / traced.summary['wall_s']:.1f}"
              f" tokens/s; the rest of the window "
              f"{rest_tokens / (window_s - slice_s):.1f} tokens/s",
              file=sys.stderr)
        outcome.trace = traced.summary
        outcome.context = {
            "trace": traced.summary,
            "prefill": {
                "config": config,
                "count": config["count"],
                "traced_steps": steps[first_traced:end_traced],
                "untraced_steps": rest,
                "untraced_s": window_s - slice_s,
            },
        }
    return outcome


def _check(config, ref, weights, tokens, sampled, kept):
    """Each kept prompt's last-position logits against the reference's:
    the widest relative error (the norm of the difference over the
    reference's, over the vocabulary) and the widest gap of one logit, in
    units of the reference's RMS logit; and the sampled prompts that the
    window never sent. Returns the checks and the prompts that fail
    either limit."""
    lim = config["check"]
    worst_row = worst_gap = 0.0
    failed = 0
    for k, got in sorted(kept.items()):
        S = tokens(k).shape[0]
        last = torch.tensor([S - 1], device=got.device)
        want = ref.forward_rows(config, weights, tokens(k), last)[0]
        diff = got.float() - want
        row = float(diff.norm() / want.norm())
        gap = float(diff.abs().max() / want.square().mean().sqrt())
        print(f"compared prompt {k}: {S} tokens, row error {row:.6g}, "
              f"logit gap {gap:.6g}", file=sys.stderr)
        failed += row > lim["row_err_max"] or gap > lim["logit_gap_max"]
        worst_row, worst_gap = max(worst_row, row), max(worst_gap, gap)
    checks = {
        "row_err_max": (worst_row, lim["row_err_max"]),
        "logit_gap_max": (worst_gap, lim["logit_gap_max"]),
        # a window too short to send them all compares nothing of the rest
        "sampled_not_sent": (len(sampled) - len(kept), 0),
    }
    return checks, failed
