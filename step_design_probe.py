#!/usr/bin/env python3
"""Design probe of K5's fused step kernel (``csrc/power_step.cu``
``step_grid``) on one CUDA card: the choices its source makes, each
against the alternatives it was chosen over, in one run.

Each variant is the kernel's source with one or more of its lines
replaced (``VARIANTS``; a replacement that no longer matches the source
stops the probe). Every variant is compiled with nvcc, in parallel, with
``-Xptxas -v`` (registers and spill bytes of every instantiation), then
run at the step shapes of chip_smoke.py's windows: the collapsed
config-5 kind window and the 2M- and 10M-span giant windows. At each
shape every variant's window is first held bitwise to the plain step
over a chain of steps, then timed a step by CUDA events behind a device
spin, as chip_smoke.py times the kernel, in turns: the variants in
order, then reversed, twice over.

    python3 step_design_probe.py [--reps 20] [--out chiprun_out/step_probe.json]

Needs a CUDA card and nvcc; exits 2 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as smoke

# The kernel's source lines that the variants replace.
SLOTS = "constexpr int kSlots = 12;"
BOUND = "constexpr int kMinBlocksPerSm = 4;"
REG_CARRY = "constexpr int kRegisterCarrySlots = 8;"
STAGE_DECL = "__shared__ float old_s[kStaged ? S * kThreads : 1];"
STAGE_COPY = "if (k * kThreads < lim) stage(old_s + k * kThreads + t, old + k * kThreads);"
STAGE_READ = "ok_old = ok ? old_s[k * kThreads + t] : 0.0f;"
# The carry in read in phase 2 by __ldg in place of staging it.
LDG = [(STAGE_DECL, "__shared__ float old_s[1];"), (STAGE_COPY, ""),
       (STAGE_READ, "ok_old = ok ? __ldg(old + k * kThreads) : 0.0f;")]

VARIANTS = {
    "source": [],
    # More register slots (they spill at 4 blocks an SM) and a bound of 5
    # blocks an SM (48 registers).
    "slots16": [(SLOTS, "constexpr int kSlots = 16;")],
    "slots20": [(SLOTS, "constexpr int kSlots = 20;")],
    "slots24": [(SLOTS, "constexpr int kSlots = 24;")],
    "bound5": [(BOUND, "constexpr int kMinBlocksPerSm = 5;")],
    # The carry in past 8 slots, and at every slot count, by __ldg.
    "ldg_past_8": LDG,
    "ldg_all": [(REG_CARRY, "constexpr int kRegisterCarrySlots = 0;")] + LDG,
}

# (V, T) per partition: chip_smoke.py's step shapes.
SHAPES = {
    "config5_kind": [(3072, 96), (3072, 8)],
    "giant_2m": [(2048, 262144), (2048, 262144)],
    "giant_10m": [(2048, 1310720), (2048, 1310720)],
}
CHAIN = 3  # steps of the bitwise chain: the window's carry buffers 0 -> 1 -> 2 -> 1


def variant_source(text: str, patches) -> str:
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"step_design_probe: the source no longer holds {old!r} once")
        text = text.replace(old, new)
    return text


def build(step, name: str, patches, out_dir: Path) -> dict:
    """Compile one variant into ``out_dir``; its library path and ptxas's
    registers and spill bytes by instantiation."""
    src = out_dir / f"power_step_{name}.cu"
    src.write_text(variant_source(step.SOURCE.read_text(), patches))
    lib = out_dir / f"libstep_{name}.so"
    cmd = step.build_command(lib)
    cmd[-1] = str(src)
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"step_design_probe: {name} does not build:\n{proc.stderr[-3000:]}")
    per_s = {}
    for lines in smoke.ptxas_all(proc.stdout + proc.stderr, "step_grid"):
        # The single-window instantiation (kStacked false): what it times.
        s_of = re.search(r"step_gridILi(\d+)ELb0E", lines[0])
        text = " ".join(lines)
        regs = re.search(r"Used (\d+) registers", text)
        spill = re.search(r"(\d+) bytes spill stores", text)
        smem = re.search(r"(\d+) bytes smem", text)
        if s_of and regs:
            per_s[int(s_of.group(1))] = {
                "registers": int(regs.group(1)),
                "spill_store_bytes": int(spill.group(1)) if spill else 0,
                "smem_bytes": int(smem.group(1)) if smem else 0,
            }
    return {"lib": str(lib), "instantiations": dict(sorted(per_s.items()))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=str(smoke.ROOT / "chiprun_out" / "step_probe.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("step_design_probe: no CUDA card", file=sys.stderr)
        return 2
    from microrank_tpu_torch.config import PageRankConfig
    from microrank_tpu_torch.ops import step

    out_dir = step.LIB_PATH.parent / "step_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futures = {n: pool.submit(build, step, n, p, out_dir) for n, p in VARIANTS.items()}
        built = {n: f.result() for n, f in futures.items()}
    libs = {n: step._bind(ctypes.CDLL(b["lib"])) for n, b in built.items()}

    def use(name):
        # Every window set up after this launches the variant's kernel.
        step._lib = libs[name]
        step._configs.clear()

    dev = torch.device("cuda")
    cfg = PageRankConfig()
    result = {"nvidia_smi": smoke.power_line(), "torch": torch.__version__,
              "cuda": torch.version.cuda, "reps": args.reps, "variants": {}, "shapes": {}}
    for name in VARIANTS:
        use(name)
        kc = step.kernel_config(dev)
        result["variants"][name] = {"patches": VARIANTS[name], "blocks_per_sm": kc.blocks_per_sm,
                                    "max_blocks": kc.max_blocks,
                                    "instantiations": built[name]["instantiations"]}
    order = list(VARIANTS)
    turns = order + order[::-1] + order + order[::-1]
    for shape, sizes in SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(5)
        products, carry, prefs = smoke.random_step_inputs(torch, gen, sizes, dev)
        plan = step.step_plan(prefs, cfg.call_weight, cfg.damping, None, True,
                              step.step_scratch(dev))
        want = smoke.step_chain(torch, step.power_step_plain, plan, products, carry, CHAIN)
        wins, row = {}, {}
        for name in order:
            use(name)
            got = smoke.step_chain(torch, None, plan, products, carry, CHAIN)
            torch.cuda.synchronize()
            smoke.check(torch.equal(got, want), f"{shape}: {name} differs from the plain step")
            res = torch.zeros((2, smoke.STEPS), dtype=torch.float32, device=dev)
            wins[name] = step.StepWindow(plan, carry, res)
            w = wins[name]
            row[name] = {"grid": w.grid, "elements_per_thread": w.per_thread,
                         "register_slots": w.slots, "ms": []}
        for name in turns:
            t, _ = smoke.spin_event_host_ms(torch, lambda: wins[name].step(products, 0),
                                            args.reps)
            row[name]["ms"].append(t)
        for name in order:
            row[name]["min_ms"] = min(row[name]["ms"])
        nbytes, bound_ms = smoke.step_bound(sizes)
        result["shapes"][shape] = {"sizes": sizes, "bound_bytes": nbytes, "bound_ms": bound_ms,
                                   "bitwise_vs_plain": True, "by_variant": row}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    for shape, r in result["shapes"].items():
        print(shape, {n: (v["register_slots"], v["elements_per_thread"], v["min_ms"])
                      for n, v in r["by_variant"].items()})
    print(json.dumps({"variants": {n: {"blocks_per_sm": v["blocks_per_sm"],
                                       "spills": {s: i["spill_store_bytes"]
                                                  for s, i in v["instantiations"].items()}}
                                   for n, v in result["variants"].items()}}))
    print(smoke.power_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
