#!/usr/bin/env python3
"""Where kernel 4 (TensorNet's fused edge MLP) and row 8 (the cell-blocked
neighbour sum) of the PyTorch/CUDA port spend their time.

``ncu`` does not run on the card's machine, so this script attributes a
kernel's device time by cutting one phase out of a copy of its source at
a time (a text edit each), building every copy beside the original with
``nvcc``, and timing them in turns with ``chip_smoke.device_ms`` at the
dhfr shapes: kernel 4 on the brute K=64 list of the 2,489-atom system and
on the grouped cell-blocked K′ list of its 16-row sort (the dhfr exact and
dhfr blocked exact paths), row 8 on that grouped list and on the brute
K=64 list of the same sort (``chip_smoke.dhfr_inputs``,
``chip_smoke.dhfr_blocked_inputs``).  A cut copy computes a wrong result;
only its time is read.  The original, and each launch-plan variant of
kernel 4 (the same source, another grid), is held against the plain
versions.

    python3 tools/torch_dhfr_phases.py --design new
    python3 tools/torch_dhfr_phases.py --design old \\
        --edge-source PARENT/torchmdnet_tpu_torch/csrc/edge_mlp.cu \\
        --mp-source PARENT/torchmdnet_tpu_torch/csrc/blocked_mp.cu

``--design old`` reads the SIMT kernels that the present ones replaced
(``edge_mlp_kernel<RM>`` and the scalar ``blocked_sum_kernel``; a ``git
archive`` of an earlier commit holds them) and calls their C entry points
as their wrappers did; ``--design new`` reads the repository's sources
(or the ones given) and calls them as ``ops/edge_mlp.py`` and
``ops/blocked_mp.py`` do.  The shared headers are copied from each
source's own directory.  The copies are written under
``_checkout/dhfr_phases/`` (git-ignored).  Each line of output is one
JSON object; the last holds the median device ms of every form.  Needs
one card.
"""

import argparse
import re
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from torchmdnet_tpu_torch.ops import blocked_mp as bm  # noqa: E402
from torchmdnet_tpu_torch.ops import edge_mlp as em  # noqa: E402
from torchmdnet_tpu_torch.ops.config import set_matmul_precision  # noqa: E402
from torchmdnet_tpu_torch.ops.kernels import (  # noqa: E402
    CSRC, I32, I64, P, CudaSource, Kernel, build, ptr)

ZERO_ACC = ("for (int i = 0; i < RM; ++i) for (int j = 0; j < 8; ++j) "
            "acc[i][j] = 1e-3f * j;")
# source → cut → [(text of the source, its replacement)]; every text must
# occur exactly once.  The SIMT kernel 4: "layer1", "w2", "w3": no x·W1,
# h1·W2 or h2·W3 product (its W staging included; the epilogue stays);
# "wstage": the W tiles are staged from no load (the barriers and the
# shared stores stay); "zeros": no zero stores for the cw = 0 slots;
# "compact_only": the compaction and the zero stores alone.  The scalar
# row 8: "stage": the attr tiles are staged from no load; "gather": every
# neighbour load reads row 0 (an L1 hit: the gathers' cost); "sum": no
# neighbour sum (its loads, FMAs and the accumulator update); "writeback":
# the accumulator is not written out; "compact_only": the compaction, the
# row starts and the accumulator's zeroing alone.
OLD_CUTS = {
    "edge_mlp": {
        "layer1": [("tile_product<RM>(sX, ldx, w1, R, F, c0, sW, acc);",
                    ZERO_ACC)],
        "w2": [("tile_product<RM>(sA, lda, w2, F, F2, c0, sW, acc);",
                ZERO_ACC)],
        "w3": [("tile_product<RM>(sH, ldh, w3, F2, F3, c0, sW, acc);",
                ZERO_ACC)],
        "wstage": [("w = *reinterpret_cast<const float4*>(W + (long long)"
                    "(k0 + row) * ncols + c0 + col);",
                    "w = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "zeros": [("for (int v = tid; v < ndead * c4; v += kThreads) {",
                   "for (int v = tid; v < 0; v += kThreads) {")],
        "compact_only": [("  float acc[RM][8];\n  const int r4 = R / 4;",
                          "  return;\n  float acc[RM][8];\n"
                          "  const int r4 = R / 4;")],
    },
    "blocked_mp": {
        "stage": [("a = *reinterpret_cast<const float4*>(\n              "
                   "attr + (s0 + sLive[t0 + s]) * C3 + c0 + col);",
                   "a = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "gather": [("feats[(long long)sJ[s] * C9 + dcol]", "feats[dcol]")],
        "sum": [("        for (int s = a; s < b; ++s)\n          acc = "
                 "fmaf(sA[s * kLdA + cl], feats[(long long)sJ[s] * C9 + "
                 "dcol], acc);", "        acc = (float)(b - a);")],
        "writeback": [("out[(long long)r0 * C9 + v] = sAcc[v];",
                       "if (sAcc[v] == 12345.0f) out[(long long)r0 * C9 + v]"
                       " = sAcc[v];")],
        "compact_only": [("row_starts(sLive, nlive, K, kRows, sStart);",
                          "row_starts(sLive, nlive, K, kRows, sStart);\n"
                          "  return;")],
    },
}
ZERO_FRAG = ("for (int i = 0; i < 8; ++i) for (int e = 0; e < 4; ++e) "
             "acc[i][e] = 1e-3f * i;")
# The tensor-core kernel 4 (edge_mlp_tc_kernel<true, ·>; the cuts reach
# kernel 3 too, which is not timed here): "layer1", "w2", "w3": no x·W1,
# sA·W2 or h2·W3 product (its ring of W stages included; the epilogue
# stays); "stage": only the first two W stages of each pass are copied
# into the ring (the later products read stale stages); "xstage": the x
# tile is staged from no load; "zeros": no zero stores for the cw = 0
# slots; "compact_only": the compaction and the zero stores alone;
# "store": the output tile is not stored.  Design variants of kernel 4
# (held against the plain version): "slots", the blocks' runs of equal
# slot counts (a live slot weighing as a dead one); "nocarry", every
# window's partial tile run where it falls (no slots carried over);
# "even", runs of equal chunk counts (the run starts unread); "win2048",
# 2,048-slot windows; "weight4", "weight8", "weight32", a live slot
# weighing 4, 8 or 32 dead ones (16 in the source).  The warp-per-row
# row 8: "gather": every neighbour load reads row 0 (an L1 hit: the L2
# gathers' cost); "attr": attr is read from no load; "walk": the mask and list walk
# alone (no loads of attr or features, no FMAs); "writeback": the sums
# are not stored.  Design variants of row 8 (held against the plain
# version): "ldg_attr", attr through the read-only path (not streaming);
# "warps8", eight row tasks a block.
NEW_CUTS = {
    "edge_mlp": {
        "layer1": [("chain_product<kWide>(sX, ldx, img1, R, p, sR, acc);",
                    ZERO_FRAG)],
        "w2": [("chain_product<kWide>(sA, lda, img2, F, p, sR, acc);",
                ZERO_FRAG)],
        "w3": [("chain_product<kWide>(sH, ldh, img3, F2, p, sR, acc);",
                ZERO_FRAG + " __syncthreads();")],
        "stage": [("  if (kt + 2 < nk)\n    tc_copy_half(",
                   "  if (kt + 2 < nk && kt < 0)\n    tc_copy_half(",
                   "tc_tile.cuh")],
        "xstage": [("x = *reinterpret_cast<const float4*>(in + (s0 + "
                    "sLive[t0 + r]) * R + col);",
                    "x = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "zeros": [("for (int v = tid; v < ndead * c4; v += kTcThreads)",
                   "for (int v = tid; v < 0; v += kTcThreads)")],
        "compact_only": [("  for (int t0 = 0; t0 < ntiles * kTcM; t0 += kTcM) {",
                          "  for (int t0 = 0; t0 < 0 * ntiles; t0 += kTcM) {"),
                         ("  nlive = held_over;", "  nlive = 0;")],
        "store": [("        if (col < F3)\n          *reinterpret_cast<float4*>"
                   "(out + (s0 + sLive[t0 + r]) * F3 + col) =",
                   "        if (col < 0)\n          *reinterpret_cast<float4*>"
                   "(out + (s0 + sLive[t0 + r]) * F3 + col) =")],
        "slots": [("constexpr int kLiveWeight = 16;",
                   "constexpr int kLiveWeight = 0;")],
        "nocarry": [("  const int ntiles = w0 + kWin < s1 ? nlive / kTcM : "
                     "(nlive + kTcM - 1) / kTcM;",
                     "  const int ntiles = (nlive + kTcM - 1) / kTcM;")],
        "even": [("  const long long s0 = (long long)ranges[blockIdx.x] * kChunk;\n"
                  "  const long long s1 = min(E, (long long)ranges[blockIdx.x + "
                  "1] * kChunk);",
                  "  const long long s0 = (long long)((E + kChunk - 1) / kChunk"
                  " * blockIdx.x / gridDim.x) * kChunk;\n  const long long s1 ="
                  " min(E, (long long)((E + kChunk - 1) / kChunk * (blockIdx.x"
                  " + 1) / gridDim.x) * kChunk);")],
        "win2048": [("constexpr int kWin = 1024;", "constexpr int kWin = 2048;")],
        "weight4": [("constexpr int kLiveWeight = 16;",
                     "constexpr int kLiveWeight = 4;")],
        "weight8": [("constexpr int kLiveWeight = 16;",
                     "constexpr int kLiveWeight = 8;")],
        "weight32": [("constexpr int kLiveWeight = 16;",
                      "constexpr int kLiveWeight = 32;")],
    },
    "blocked_mp": {
        "gather": [("const float* x = feats + jb * C9 + c;",
                    "const float* x = feats + c;")],
        "attr": [("w[q] = __ldcs(reinterpret_cast<const float4*>(a + q * F));",
                  "w[q] = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "walk": [("      if (!on) continue;", "      if (on || !on) continue;")],
        "writeback": [("      *reinterpret_cast<float4*>(out + (long long)row "
                       "* C9 + d * F + c) = o[d];",
                       "      if (o[d].x == 12345.0f) *reinterpret_cast<"
                       "float4*>(out + (long long)row * C9 + d * F + c) = "
                       "o[d];")],
        "ldg_attr": [("w[q] = __ldcs(reinterpret_cast<const float4*>(a + q * "
                      "F));", "w[q] = __ldg(reinterpret_cast<const float4*>(a"
                      " + q * F));")],
        "warps8": [("constexpr int kSumThreads = 128;",
                    "constexpr int kSumThreads = 256;")],
    },
}
VARIANTS = ("slots", "nocarry", "even", "win2048", "weight4", "weight8",
            "weight32", "ldg_attr", "warps8")
# kernel 4's launch-plan variants on the same source, the grid from E and
# the SM count (each block still takes a run of equal cost): "grid2x", two
# blocks an SM's worth, in two waves; "grid1024", a block a 1,024 slots
# (kernel 3's plan before this design: many short runs, scheduled by the
# card as blocks finish); "grid128", 128 blocks
PLANS = {
    "grid2x": lambda e, sms: 2 * sms,
    "grid1024": lambda e, sms: -(-e // 1024),
    "grid128": lambda e, sms: 128,
}
OLD_FUSED = [P] * 9 + [I64, I32, I32]


def variants(source: Path, cuts: dict, out: Path):
    """A ``CudaSource`` for each cut copy of ``source``, with the shared
    headers of its own directory beside it (where ``nvcc`` resolves its
    includes)."""
    text = source.read_text()
    made = {}
    for name, edits in cuts.items():
        body = text
        headers = {h.name: h.read_text() for h in source.parent.glob("*.cuh")}
        for old, new, *where in edits:
            target = where[0] if where else None
            now = headers[target] if target else body
            if now.count(old) != 1:
                raise SystemExit(f"cut {name}: {old[:50]!r} occurs "
                                 f"{now.count(old)} times")
            if target:
                headers[target] = now.replace(old, new)
            else:
                body = now.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for h, htext in headers.items():
            (d / h).write_text(htext)
        (d / source.name).write_text(f"// phase cut: {name}\n" + body)
        src = CudaSource(source.name)
        src.path = d / source.name
        made[name] = src
    return made


def ptxas_table(log: str) -> dict:
    """Each kernel's (registers, spill-store bytes) from ``ptxas -v``, by
    its mangled name."""
    table, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.split("for ")[-1].strip()
            table[name] = [None, None]
        elif name and "spill stores" in ln:
            table[name][1] = int(ln.split("bytes spill stores")[0]
                                 .split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            table[name][0] = int(ln.split("Used ")[1].split()[0])
    return {k: v for k, v in table.items()
            if re.search(r"edge_mlp|blocked_sum_kernel", k)}


def fused_old(src: CudaSource, w):
    """Kernel 4 of the old source, called as its wrapper did."""
    fn = Kernel(src, "tmd_edge_mlp", OLD_FUSED)
    x = w[0]
    n, k, r = x.shape
    f = w[2].shape[-1]

    def run():
        out = torch.empty((n, k, 3 * f), device=x.device)
        fn(*(ptr(t) for t in w), ptr(out), n * k, r, f)
        return out
    return run


def fused_new(src: CudaSource, w, plan=None):
    """Kernel 4 of ``src`` as ``ops/edge_mlp.py::edge_mlp_cuda`` calls
    it; ``plan(e, sms)`` gives another grid."""
    fn = Kernel(src, em.FUSED.symbol, em.FUSED.argtypes)
    x = w[0]
    n, k, r = x.shape
    f = w[2].shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid, chunks, _, image_n, tiles_n = em.launch_plan(
        n * k, f, sms, r)["edge_mlp"]
    if plan is not None:
        grid = plan(n * k, sms)
        tiles_n = grid * em.fused_tile_floats(r, f)

    def run():
        out = torch.empty((n, k, 3 * f), device=x.device)
        image = torch.empty(image_n, device=x.device)
        tiles = torch.empty(max(tiles_n, 1), device=x.device)
        counts = torch.empty(chunks + grid + 1, dtype=torch.int32,
                             device=x.device)
        fn(*(ptr(t) for t in w), ptr(out), ptr(image), ptr(tiles),
           ptr(counts), n * k, r, f, grid)
        return out
    return run


def sum_calls(src: CudaSource, v):
    """Row 8 of ``src`` through ``ops/blocked_mp.py`` (the old and the new
    entry point take the same arguments)."""
    fn = Kernel(src, bm.SUM.symbol, bm.SUM.argtypes)
    args = (v["attr"], v["feats"], v["idx"], v["mask"])

    def run():
        saved, bm.SUM = bm.SUM, fn
        try:
            return bm.neighbor_sum_cuda(*args)
        finally:
            bm.SUM = saved
    return run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--design", choices=("old", "new"), required=True)
    ap.add_argument("--edge-source", type=Path, default=CSRC / "edge_mlp.cu")
    ap.add_argument("--mp-source", type=Path, default=CSRC / "blocked_mp.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dhfr_phases: CUDA is not available", file=sys.stderr)
        return 2
    cuts = OLD_CUTS if args.design == "old" else NEW_CUTS
    out = ROOT / "_checkout" / "dhfr_phases" / args.design
    forms = {}
    for key, source in (("edge_mlp", args.edge_source),
                        ("blocked_mp", args.mp_source)):
        full = CudaSource(source.name)
        full.path = source.resolve()
        forms[key] = {"full": full,
                      **variants(source.resolve(), cuts[key], out / key)}
    logs = build([src for f in forms.values() for src in f.values()])
    cs.emit({"phase": "build", "design": args.design,
             "sources": [str(args.edge_source), str(args.mp_source)],
             "ptxas": {f"{key}/{name}": ptxas_table(
                 src.library_path().with_suffix(".log").read_text())
                 for key, f in forms.items() for name, src in f.items()},
             "logs": len(logs)})

    set_matmul_precision("highest")
    dhfr, seg = cs.dhfr_system()
    pos = torch.as_tensor(dhfr[1], device="cuda")
    v4 = cs.dhfr_inputs(dhfr, seg, 55)
    blocked = {}
    for layout, grouped in (("grouped", True), ("ungrouped", False)):
        spec = cs.dhfr_blocked_spec(dhfr, grouped)
        blocked[layout], _ = cs.dhfr_blocked_inputs(
            cs.BlockedDhfr(dhfr, seg, spec), pos, 66)
    mlp = {"brute": [v4["x"], v4["cw"], *v4["mlp"]],
           "grouped": [blocked["grouped"][k] for k in ("x", "cw")]
           + blocked["grouped"]["mlp"]}

    calls, plain = {}, {}
    make4 = fused_old if args.design == "old" else fused_new
    for lst, w in mlp.items():
        plain[f"edge_mlp@{lst}"] = lambda w=w: em.edge_mlp_ref(*w)
        for name, src in forms["edge_mlp"].items():
            calls[f"edge_mlp@{lst}/{name}"] = make4(src, w)
        if args.design == "new":
            for name, plan in PLANS.items():
                calls[f"edge_mlp@{lst}/{name}"] = fused_new(
                    forms["edge_mlp"]["full"], w, plan)
    for lst, v in blocked.items():
        args8 = (v["attr"], v["feats"], v["idx"], v["mask"])
        plain[f"blocked_mp_sum@{lst}"] = (
            lambda a=args8: bm.neighbor_sum_ref(*a))
        for name, src in forms["blocked_mp"].items():
            calls[f"blocked_mp_sum@{lst}/{name}"] = sum_calls(src, v)
    errs = {}
    for name, fn in calls.items():
        form = name.split("/")[1]
        if form == "full" or form in PLANS or form in VARIANTS:
            try:
                errs[name] = cs.compare(fn, plain[name.split("/")[0]])[1]
            except AssertionError as e:  # a non-finite output
                errs[name] = str(e)
    cs.emit({"phase": "vs_plain", "max_rel_err": errs,
             "slots": {lst: int(w[1].numel()) for lst, w in mlp.items()},
             "live_slots": {lst: int((w[1] != 0).sum())
                            for lst, w in mlp.items()},
             "valid_slots": {lst: int(v["mask"].sum())
                             for lst, v in blocked.items()},
             "k": {lst: int(v["idx"].shape[1]) for lst, v in blocked.items()}})
    times = {}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            times.setdefault(name, []).append(cs.device_ms(fn))
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.emit({"phase": "device_ms", "design": args.design, "nvidia_smi": smi,
             "device_ms": times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
