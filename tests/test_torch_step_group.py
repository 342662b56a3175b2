"""K5's grid plan (``ops.step.grid_plan``) and a stacked group's step on
the CPU.

* the plan: over four vector lengths of 1 to 3M, 1 to 8 windows and a
  grid of 4 to 1,056 blocks, its units cover every element of every
  (vector, window) exactly once (the kernels' unit-to-chunk map,
  ``unit_at``, repeated here); it never plans more units than the grid
  holds, unless every (vector, window) is one unit and the windows
  outnumber the grid's rows (the blocks then walk the rest); its
  per_thread is the least that fits and its slots the least
  instantiation that holds it;
  one window gets the plan the C library made before the plan moved to
  the host; PR 13's kernel gets units of 256 elements; bad input is
  refused.
* the group's step: a chain of plain steps over a stacked [B, n] carry
  with a tol, whose windows freeze at different steps, is bitwise each
  window's own chain (with int8 scales too).

The kernel itself needs the card (``tests/test_torch_batched_cuda.py``,
``tests/test_torch_step.py``). This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_step_group.py
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from microrank_tpu_torch.ops import pattern, step

THREADS = step.THREADS
MOST_SLOTS = 12  # csrc kSlots / kGroupSlots
HELD_MAX = 32    # csrc kHeldMax

lengths = st.lists(st.integers(1, 3_000_000), min_size=4, max_size=4)
windows = st.integers(1, 8)
max_blocks = st.integers(4, 1056)


def units_at(ns, b, per):
    return b * sum(-(-n // (THREADS * per)) for n in ns)


def chunks(plan, ns, b):
    """Each unit's (vector, window, first element, end) as the kernels'
    ``unit_at`` works them out: unit x of window w, a grid row a window."""
    out = []
    per_window = sum(plan.blocks)
    assert plan.units == b * per_window
    for w in range(b):
        for x in range(per_window):
            vi = max(i for i in range(4) if plan.first[i] <= x)
            start = (x - plan.first[vi]) * plan.per_thread * THREADS
            out.append((vi, w, start, min(start + plan.per_thread * THREADS, ns[vi])))
    return out


@settings(max_examples=150, deadline=None)
@given(ns=lengths, b=windows, cap=max_blocks)
def test_grid_plan_covers_every_element_of_every_window_once(ns, b, cap):
    plan = step.grid_plan(ns, b, cap, MOST_SLOTS, HELD_MAX)
    assert plan.units == units_at(ns, b, plan.per_thread)
    assert plan.blocks == tuple(-(-n // (THREADS * plan.per_thread)) for n in ns)
    covered = {}
    for vi, w, start, end in chunks(plan, ns, b):
        assert start < end  # no unit without an element
        covered.setdefault((vi, w), []).append((start, end))
    assert sorted(covered) == [(vi, w) for vi in range(4) for w in range(b)]
    for (vi, _), runs in covered.items():
        runs.sort()
        assert runs[0][0] == 0 and runs[-1][1] == ns[vi]
        assert all(a[1] == c[0] for a, c in zip(runs, runs[1:]))  # no gap, no overlap


@settings(max_examples=150, deadline=None)
@given(ns=lengths, b=windows, cap=max_blocks)
def test_grid_plan_never_plans_more_units_than_the_grid(ns, b, cap):
    plan = step.grid_plan(ns, b, cap, MOST_SLOTS, HELD_MAX)
    assert plan.grid <= cap
    per_window = sum(plan.blocks)
    if 4 * b <= cap:
        # A block a unit: a row of the grid a window, every window a row.
        assert plan.units <= cap and plan.grid == plan.units
        assert plan.grid_windows == (b if b > 1 else 1)
    else:
        # More windows than rows of 4 units fit: one unit a (vector,
        # window), the rows walk the windows past the grid.
        assert plan.units == 4 * b and plan.blocks == (1, 1, 1, 1)
        assert plan.grid_windows == cap // 4 < b and plan.grid == 4 * plan.grid_windows
    assert plan.grid == per_window * plan.grid_windows or b == 1


@settings(max_examples=150, deadline=None)
@given(ns=lengths, b=windows, cap=max_blocks, held_max=st.sampled_from([0, HELD_MAX]))
def test_grid_plan_takes_the_least_per_thread_and_instantiation(ns, b, cap, held_max):
    plan = step.grid_plan(ns, b, cap, MOST_SLOTS, held_max)
    room = max(cap, 4 * b)
    per = plan.per_thread
    assert units_at(ns, b, per) <= room
    assert per == 1 or units_at(ns, b, per - 1) > room
    held_slots = [s for s in (1, 2, 4, 8, MOST_SLOTS) if s >= per]
    assert plan.slots == (held_slots[0] if held_slots else MOST_SLOTS)
    assert plan.kernel == (step.KERNEL_WINDOW if b == 1 else step.KERNEL_GROUP)
    if b == 1:
        assert plan.held == 0 and plan.kernel_name == f"step_grid<{plan.slots}>"
    else:
        assert plan.held == min(max(per - plan.slots, 0), held_max)
        assert plan.kernel_name == f"step_grid_group<{plan.slots}>"


def previous_window_plan(ns, cap):
    """The C library's plan of one window before the plan moved to the
    host (mr_step_window_create at PR 17): per_thread from the total,
    raised until the units fit; each vector's run of blocks."""
    chunk0 = THREADS * cap
    total = sum(ns)
    per = total // chunk0 if total // chunk0 > 1 else 1
    while units_at(ns, 1, per) > cap:
        per += 1
    blocks = [-(-n // (THREADS * per)) for n in ns]
    first = [sum(blocks[:i]) for i in range(4)]
    units = units_at(ns, 1, per)
    slots = next((s for s in (1, 2, 4, 8) if per <= s), MOST_SLOTS)
    return per, slots, units, min(units, cap), tuple(first), tuple(blocks)


@settings(max_examples=200, deadline=None)
@given(ns=lengths, cap=max_blocks)
def test_grid_plan_of_one_window_is_the_previous_plan(ns, cap):
    plan = step.grid_plan(ns, 1, cap, MOST_SLOTS, HELD_MAX)
    assert (plan.per_thread, plan.slots, plan.units, plan.grid, plan.first,
            plan.blocks) == previous_window_plan(ns, cap)


@pytest.mark.parametrize("ns,cap,per", [
    ([96, 3072, 8, 3072], 528, 1),                      # config-5 kind, one window
    ([262_144, 2048, 262_144, 2048], 528, 4),           # the 2M-span giant window
    ([1_310_720, 2048, 1_310_720, 2048], 528, 20),      # the 10M-span giant window
])
def test_grid_plan_at_the_main_paths_window_shapes(ns, cap, per):
    plan = step.grid_plan(ns, 1, cap, MOST_SLOTS, HELD_MAX)
    assert plan.per_thread == per and plan.grid <= cap


@pytest.mark.parametrize("b,ns,per,slots,held", [
    (6, [96, 3072, 8, 3072], 1, 1, 0),                  # config-5 kind, B = 6: 156 units
    (2, [262_144, 2048, 262_144, 2048], 8, 8, 0),       # giant-2M x 2
    (2, [1_310_720, 2048, 1_310_720, 2048], 40, 12, 28),  # giant-10M x 2
])
def test_grid_plan_at_the_main_paths_group_shapes(b, ns, per, slots, held):
    plan = step.grid_plan(ns, b, 528, MOST_SLOTS, HELD_MAX)
    assert (plan.per_thread, plan.slots, plan.held) == (per, slots, held)
    assert plan.units == plan.grid <= 528
    recompute = step.grid_plan(ns, b, 528, MOST_SLOTS, 0)
    assert recompute._replace(held=held) == plan


@settings(max_examples=100, deadline=None)
@given(ns=lengths, b=windows, cap=max_blocks)
def test_grid_plan_of_pr13s_kernel_walks_units_of_256(ns, b, cap):
    plan = step.grid_plan(ns, b, cap, MOST_SLOTS, HELD_MAX, units_kernel=True)
    assert (plan.kernel, plan.per_thread, plan.slots, plan.held) == (step.KERNEL_UNITS, 1, 0, 0)
    assert plan.units == units_at(ns, b, 1) and plan.grid == min(plan.units, cap)
    assert plan.grid_windows == 1
    assert plan.kernel_name == "step_grid_units"


@pytest.mark.parametrize("ns,b,cap", [
    ([5, 5, 5], 1, 528),        # three lengths
    ([5, 0, 5, 5], 1, 528),     # an empty vector
    ([5, 5, 5, 5], 0, 528),     # no window
    ([5, 5, 5, 5], 2, 3),       # fewer blocks than vectors
])
def test_grid_plan_refuses_bad_input(ns, b, cap):
    with pytest.raises(ValueError):
        step.grid_plan(ns, b, cap, MOST_SLOTS)


# ------------------------------------------------ a group's step, plain


def stacked_inputs(rng, b, sizes):
    """[B, n] float32 products, carry and preference vectors per
    partition of (V, T) = sizes[p]."""
    def vec(n):
        return torch.from_numpy(rng.uniform(0.0, 1.0, (b, n)).astype(np.float32))

    products = tuple((vec(v), vec(v), vec(t)) for v, t in sizes)
    carry = tuple((vec(v), vec(t)) for v, t in sizes)
    prefs = [vec(t) for _, t in sizes]
    return products, carry, prefs


def scale_group(rng, b, sizes):
    bitmaps = [torch.from_numpy(rng.integers(0, 256, (b, v, -(-t // 8)), dtype=np.uint8))
               for v, t in sizes]
    return pattern.pattern_group(
        bitmaps,
        [torch.from_numpy(rng.uniform(0, 1, (b, t)).astype(np.float32)) for _, t in sizes],
        [torch.from_numpy(rng.uniform(0, 1, (b, v)).astype(np.float32)) for v, _ in sizes],
        [None, None], [t for _, t in sizes],
    )


def chain(plan, products, carry, n_steps, moving, want_scales):
    """``n_steps`` plain steps of one StepWindow: each step's products
    the fixed ones, those of the windows in ``moving`` times the carry
    (so those windows move and the others repeat their first step).
    Returns every step's carry and scales, then the residual trace,
    n_iters and running."""
    lead = tuple(carry[0][0].shape[:-1])
    residuals = torch.zeros(lead + (2, n_steps), dtype=torch.float32)
    n_iters = torch.zeros(lead, dtype=torch.int32)
    running = torch.ones(lead, dtype=torch.bool)
    win = step.StepWindow(plan, carry, residuals, n_iters, running)
    out, c = [], carry
    for i in range(n_steps):
        ys = tuple(
            (torch.where(moving, y0 * sv, y0), y1, torch.where(moving, y2 * rv, y2))
            for (y0, y1, y2), (sv, rv) in zip(products, c)
        )
        c, scales = win.step(ys, i, want_scales and i + 1 < n_steps)
        out.append(([t.clone() for part in c for t in part],
                    None if scales is None else scales.clone()))
    return out, residuals, n_iters, running


@pytest.mark.parametrize("b", [2, 3, 6])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_stacked_plain_chain_with_tol_is_each_windows_own_chain(b, int8):
    rng = np.random.default_rng(40 + b)
    sizes = [(37, 53), (40, 106)]
    products, carry, prefs = stacked_inputs(rng, b, sizes)
    group = scale_group(rng, b, sizes) if int8 else None
    # Odd windows move (their products follow the carry); even ones
    # repeat their first step and freeze after the second.
    moving = (torch.arange(b) % 2 == 1)[:, None]
    tol = 1e-4
    n_steps = 30

    def plan_of(prefs_, group_):
        return step.step_plan(prefs_, 0.01, 0.85, tol, True, step.step_scratch("cpu", len(
            prefs_[0]) if prefs_[0].dim() == 2 else 1), group_)

    got, res, n_iters, running = chain(plan_of(prefs, group), products, carry, n_steps,
                                       moving, int8)
    assert len(set(n_iters.tolist())) > 1  # the windows froze at different steps
    for w in range(b):
        own_group = None
        if int8:
            own_group = pattern.pattern_group(
                [p.pattern[w] for p in group.parts], [p.w_len[w] for p in group.parts],
                [p.w_cov[w] for p in group.parts], [None, None],
                [p.n_cols for p in group.parts])
        own = chain(plan_of([p[w] for p in prefs], own_group),
                    tuple(tuple(y[w] for y in ys) for ys in products),
                    tuple(tuple(x[w] for x in part) for part in carry), n_steps,
                    moving[w], int8)
        for (g_carry, g_scales), (o_carry, o_scales) in zip(got, own[0]):
            for g, o in zip(g_carry, o_carry):
                assert g[w].numpy().tobytes() == o.numpy().tobytes()
            if int8 and o_scales is not None:
                assert g_scales[w].numpy().tobytes() == o_scales.numpy().tobytes()
        assert res[w].numpy().tobytes() == own[1].numpy().tobytes()
        assert int(n_iters[w]) == int(own[2]) and bool(running[w]) == bool(own[3])
