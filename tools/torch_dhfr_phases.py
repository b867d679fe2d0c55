#!/usr/bin/env python3
"""Where kernel 4 (TensorNet's fused edge MLP), rows 8 and 9 (the
cell-blocked neighbour sum and its attr cotangent) and row 6 (the
Chebyshev projection) of the PyTorch/CUDA port spend their time.

``ncu`` does not run on the card's machine, so this script attributes a
kernel's device time by cutting one phase out of a copy of its source at
a time (a text edit each), building every copy beside the original with
``nvcc``, and timing them in turns with ``chip_smoke.device_ms``: kernel
4 on the brute K=64 list of the 2,489-atom dhfr system and on the grouped
cell-blocked K′ list of its 16-row sort (the dhfr exact and dhfr blocked
exact paths), rows 8 and 9 on that grouped list and on the brute K=64
list of the same sort (``chip_smoke.dhfr_inputs``,
``chip_smoke.dhfr_blocked_inputs``), row 6 on the training batch's K=40
list (``chip_smoke.train_kernel_inputs``).  A cut copy computes a wrong
result; only its time is read.  The original, and each design or
launch-plan variant (held against the plain versions), is compared with
the plain version.

    python3 tools/torch_dhfr_phases.py --design new
    python3 tools/torch_dhfr_phases.py --design old \\
        --kernels edge_mlp,blocked_mp_sum \\
        --edge-source PARENT/torchmdnet_tpu_torch/csrc/edge_mlp.cu \\
        --mp-source PARENT/torchmdnet_tpu_torch/csrc/blocked_mp.cu
    python3 tools/torch_dhfr_phases.py --design old \\
        --kernels blocked_mp_dattr,cheb_project \\
        --mp-source PARENT/torchmdnet_tpu_torch/csrc/blocked_mp.cu \\
        --cheb-source PARENT/torchmdnet_tpu_torch/csrc/cheb_filter.cu

``--design old`` reads the kernels that the present ones replaced (a
``git archive`` of an earlier commit holds them: the SIMT
``edge_mlp_kernel<RM>`` and scalar ``blocked_sum_kernel`` of the commit
before kernel 4's and row 8's redesign, the thread-a-slot
``blocked_dattr_kernel`` and the SIMT ``project_kernel`` of the commit
before rows 9's and 6's) and calls their C entry points as their
wrappers did; ``--design new`` reads the repository's sources (or the
ones given) and calls them as ``ops/edge_mlp.py``, ``ops/blocked_mp.py``
and ``ops/cheb_filter.py`` do.  ``--kernels`` picks the kernels (all
four by default).  The shared headers are copied from each source's own
directory.  The copies are written under ``_checkout/dhfr_phases/``
(git-ignored).  Each line of output is one JSON object; the last holds
the median device ms of every form.  Needs one card.
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
from torchmdnet_tpu_torch.ops import cheb_filter as cf  # noqa: E402
from torchmdnet_tpu_torch.ops import edge_mlp as em  # noqa: E402
from torchmdnet_tpu_torch.ops.config import set_matmul_precision  # noqa: E402
from torchmdnet_tpu_torch.ops.kernels import (  # noqa: E402
    CSRC, F32, I32, I64, P, CudaSource, Kernel, build, ptr)

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
# row starts and the accumulator's zeroing alone.  The thread-a-slot row 9:
# "g9": every slot reads row 0's g9 (L1 hits); "gather": every neighbour
# load reads row 0; "fold": no loads or FMAs (the mask read and the zero
# stores stay); "stores_only": no mask read either (the index arithmetic
# and the store stream alone).  The SIMT row 6: "basis": the weighted
# basis tile without cosf; "ct": the ct tile staged from no load;
# "product": no FMA loop; "sum": the second launch adds chunk 0 only;
# "compact_only": no tile (the compaction, the partial stores and the
# second launch stay).
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
    "blocked_mp_sum": {
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
    "blocked_mp_dattr": {
        "g9": [("const float* g = g9 + (e / K) * C9 + c;",
                "const float* g = g9 + c;")],
        "gather": [("const float* x = feats + idx[e] * C9 + c;",
                    "const float* x = feats + c;")],
        "fold": [("    if (mask[e]) {", "    if (mask[e] && e < 0) {")],
        "stores_only": [("    if (mask[e]) {", "    if (e < 0) {")],
    },
    "cheb_project": {
        "basis": [("sFm[r] * cosf((float)j * sTheta[r]) : 0.0f;",
                   "sFm[r] : 0.0f;")],
        "ct": [("w = *reinterpret_cast<const float4*>(ct + e * C + c0 + col);",
                "w = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "product": [("    for (int s = 0; s < rows; ++s) {",
                     "    for (int s = 0; s < 0 * rows; ++s) {")],
        "sum": [("for (int z = 0; z < chunks; ++z) acc +=",
                 "for (int z = 0; z < 1; ++z) acc +=")],
        "compact_only": [("  for (int q0 = 0; q0 < total; q0 += kTileM) {",
                          "  for (int q0 = 0; q0 < 0 * total; q0 += kTileM) {")],
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
# "warps8", eight row tasks a block.  The warp-per-row row 9: "gather":
# every neighbour load reads row 0; "g9": g9 from no load; "zeros": the
# dead slots store nothing; "valid": the valid slots are skipped (no
# gathers, no stores); "walk": neither (the g9 loads and the round's mask
# and list reads alone).  Its design variants: "stcg", the stores cached
# in L2 (not streaming); "warps8" as row 8's; "row", a warp a whole row (g9
# loaded once a row, not once a 32-slot round); "row_occ6", the same with
# six blocks an SM asked of the compiler (every row's warp resident at
# once); "rounds2", two rounds a warp.  The tensor-core row
# 6: "basis": the A fragment without tc_cos; "copy": no ct rows copied
# (the stages split whatever the ring holds); "planes": the split ct
# planes not written (the products read stale ones; the split's shared
# loads go with them); "mma": no wgmma; "sum": the second launch adds
# the first 8 chunks only; "compact_only": no stage (the compaction, the
# partial stores and the second launch stay); "nofold": no second launch;
# "empty": no live slot (the launch, the flag loads, zero partials and
# the fold); "nofence", "onebar", "nowait": a stage without its proxy
# fence, its second barrier or its wait for the stage before's wgmma
# (unsafe, timed only).  Its design variants: "raw2",
# "raw3", a ring of 2 or 3 raw stages (the copies 1 or 2 stages ahead, not
# 3); "window2048", 2,048-slot windows (8 a thread, not 12); "k32", 32
# slots a stage (12 wgmma a wait) with a ring of 2 and 1,024-slot windows
# (two blocks an SM fit); "k32w2048", the same with 2,048-slot windows
# (one fits); its plan variants below.
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
    "blocked_mp_sum": {
        "gather": [("const float* x = feats + jb * C9 + c;\n      float4 w[3]",
                    "const float* x = feats + c;\n      float4 w[3]")],
        "attr": [("w[q] = __ldcs(reinterpret_cast<const float4*>(a + q * F));",
                  "w[q] = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "walk": [("      if (!on) continue;\n      const float* a = attr",
                  "      if (on || !on) continue;\n      const float* a = attr")],
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
    "blocked_mp_dattr": {
        "gather": [("const float* x = feats + jb * C9 + c;\n      float4 xs[9]",
                    "const float* x = feats + c;\n      float4 xs[9]")],
        "g9": [("    g[d] = on ? __ldg(reinterpret_cast<const float4*>(g9 + "
                "(long long)row * C9 + d * F + c))\n              : zero;",
                "    g[d] = make_float4(1e-3f, 1e-3f, 1e-3f, 1e-3f);")],
        "zeros": [("    unsigned dead = ~bits & (n == 32",
                   "    unsigned dead = 0u & (n == 32")],
        "valid": [("    unsigned live = bits;", "    unsigned live = 0u & bits;")],
        "walk": [("    unsigned dead = ~bits & (n == 32",
                  "    unsigned dead = 0u & (n == 32"),
                 ("    unsigned live = bits;", "    unsigned live = 0u & bits;")],
        "stcg": [("for (int w = 0; w < 3; ++w) __stcs(reinterpret_cast<float4*>"
                  "(dst + w * F), zero);",
                  "for (int w = 0; w < 3; ++w) __stcg(reinterpret_cast<float4*>"
                  "(dst + w * F), zero);"),
                 ("for (int w = 0; w < 3; ++w) __stcs(reinterpret_cast<float4*>"
                  "(dst + w * F), o[w]);",
                  "for (int w = 0; w < 3; ++w) __stcg(reinterpret_cast<float4*>"
                  "(dst + w * F), o[w]);")],
        "warps8": [("constexpr int kSumThreads = 128;",
                    "constexpr int kSumThreads = 256;")],
        "row": [("constexpr int kDattrRounds = 1;",
                 "constexpr int kDattrRounds = 0;")],
        "row_occ6": [("constexpr int kDattrRounds = 1;",
                      "constexpr int kDattrRounds = 0;"),
                     ("__global__ void __launch_bounds__(kSumThreads, 4)\n"
                      "blocked_dattr_kernel(",
                      "__global__ void __launch_bounds__(kSumThreads, 6)\n"
                      "blocked_dattr_kernel(")],
        "rounds2": [("constexpr int kDattrRounds = 1;",
                     "constexpr int kDattrRounds = 2;")],
    },
    "cheb_project": {
        "basis": [("f0 * tc_cos((float)jr0 * th0)", "f0 * th0"),
                  ("f0 * tc_cos((float)jr1 * th0)", "f0 * th0"),
                  ("f1 * tc_cos((float)jr0 * th1)", "f1 * th1"),
                  ("f1 * tc_cos((float)jr1 * th1)", "f1 * th1")],
        "copy": [("      if (r < nk) copy(r);", "      if (r < 0) copy(r);"),
                 ("      if (kt + kProjectRaw - 1 < nk) copy(kt + kProjectRaw - 1);",
                  "      if (kt < 0) copy(kt + kProjectRaw - 1);")],
        "planes": [("        *reinterpret_cast<uint4*>(buf + o / 4) =",
                    "        if (o < 0) *reinterpret_cast<uint4*>(buf + o / 4) ="),
                   ("        *reinterpret_cast<uint4*>(buf + kTcPlane + o / 4) =",
                    "        if (o < 0) *reinterpret_cast<uint4*>(buf + kTcPlane + o / 4) =")],
        "mma": [("          wgmma_tf32(acc, a[u][s2][1], dHi + 2 * s2);\n"
                 "          wgmma_tf32(acc, a[u][s2][0], dLo + 2 * s2);\n"
                 "          wgmma_tf32(acc, a[u][s2][0], dHi + 2 * s2);",
                 "          acc[u][s2] += __uint_as_float(a[u][s2][1][0] ^ "
                 "a[u][s2][0][3] ^ (uint32_t)(dHi + dLo));")],
        "sum": [("  for (int z0 = 0; z0 < chunks; z0 += 8) {",
                 "  for (int z0 = 0; z0 < 1; z0 += 8) {")],
        "compact_only": [("      if (r < nk) copy(r);", "      if (r < 0) copy(r);"),
                         ("    for (int kt = 0; kt < nk; kt += 2) {",
                          "    for (int kt = 0; kt < 0 * nk; kt += 2) {")],
        "nofold": [("  if (err != cudaSuccess || chunks == 1) return err;",
                    "  if (err != cudaSuccess || chunks >= 1) return err;")],
        "empty": [("      f[i] = sb + i < wend ? fm[sb + i] : 0.0f;",
                   "      f[i] = sb + i < 0 ? fm[sb + i] : 0.0f;")],
        "nofence": [('      asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
                     "      wg_bar();  // the warpgroup's planes",
                     "      wg_bar();  // the warpgroup's planes")],
        "onebar": [("      wg_bar();  // the warpgroup's planes of stage kt are written",
                    "      // (cut)")],
        "nowait": [("      wgmma_commit();\n      wgmma_wait<1>();",
                    "      wgmma_commit();")],
        "raw2": [("constexpr int kProjectRaw = 4;", "constexpr int kProjectRaw = 2;")],
        "raw3": [("constexpr int kProjectRaw = 4;", "constexpr int kProjectRaw = 3;")],
        "window2048": [("constexpr int kProjectPer = 12;",
                        "constexpr int kProjectPer = 8;")],
        "k32": [("constexpr int kProjectK = kTcK;",
                 "constexpr int kProjectK = 2 * kTcK;"),
                ("constexpr int kProjectRaw = 4;", "constexpr int kProjectRaw = 2;"),
                ("constexpr int kProjectPer = 12;", "constexpr int kProjectPer = 4;")],
        "k32w2048": [("constexpr int kProjectK = kTcK;",
                      "constexpr int kProjectK = 2 * kTcK;"),
                     ("constexpr int kProjectRaw = 4;",
                      "constexpr int kProjectRaw = 2;"),
                     ("constexpr int kProjectPer = 12;",
                      "constexpr int kProjectPer = 8;")],
    },
}
VARIANTS = ("slots", "nocarry", "even", "win2048", "weight4", "weight8",
            "weight32", "ldg_attr", "warps8", "stcg", "raw2", "raw3",
            "window2048", "k32", "k32w2048", "row", "row_occ6", "rounds2")
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
# row 6's launch-plan variants (the same source, the slots cut into about
# that many blocks; the plan's own is two an SM): "blocks1x", one block an
# SM; "blocks3x", three an SM's worth (two fit, in waves)
PROJECT_PLANS = {"blocks1x": 1, "blocks3x": 3}
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
            if re.search(r"edge_mlp|blocked_sum_kernel|blocked_dattr|project",
                         k)}


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


def swapped(mod, name: str, src: CudaSource, call):
    """``call()`` with ``mod.name`` (a ``Kernel``) swapped for the same
    entry point of ``src``: a wrapper of ``ops/`` launching a copy."""
    fn = Kernel(src, getattr(mod, name).symbol, getattr(mod, name).argtypes)

    def run():
        saved = getattr(mod, name)
        setattr(mod, name, fn)
        try:
            return call()
        finally:
            setattr(mod, name, saved)
    return run


def sum_calls(src: CudaSource, v):
    """Row 8 of ``src`` through ``ops/blocked_mp.py`` (the old and the new
    entry point take the same arguments)."""
    args = (v["attr"], v["feats"], v["idx"], v["mask"])
    return swapped(bm, "SUM", src, lambda: bm.neighbor_sum_cuda(*args))


def dattr_calls(src: CudaSource, v):
    """Row 9 of ``src`` through ``ops/blocked_mp.py`` (the old and the new
    entry point take the same arguments)."""
    args = (v["g9"], v["feats"], v["idx"], v["mask"])
    return swapped(bm, "DATTR", src, lambda: bm.dattr_cuda(*args))


def project_old(src: CudaSource, v, t):
    """Row 6 of the old source, called as its wrapper did: 256-slot spans
    cut into chunks for about 264 blocks over ⌈C/128⌉ × ⌈T/128⌉ tiles, at
    most 16 spans a chunk."""
    fn = Kernel(src, cf.PROJECT.symbol, [P] * 5 + [I64, I32, I32, I32, F32, F32])
    d, fm, ct = v["d"], v["fm"], v["ct"]
    e, c = d.numel(), ct.shape[-1]
    spans, tiles = -(-e // 256), -(-c // 128) * -(-t // 128)
    per = min(max(1, -(-spans * tiles // 264)), 16)
    chunks = -(-spans // per)

    def run():
        partial = torch.empty((max(chunks, 1), t, c), device=d.device)
        out = torch.empty((t, c), device=d.device)
        fn(ptr(d), ptr(fm), ptr(ct), ptr(partial), ptr(out), e, t, c, per,
           0.0, cs.TRAIN_CUTOFF)
        return out
    return run


def project_new(src: CudaSource, v, t, per_sm=None):
    """Row 6 of ``src`` as ``ops/cheb_filter.py::cheb_project_cuda`` calls
    it; ``per_sm`` cuts the slots into about that many blocks an SM (the
    plan's count otherwise)."""
    args = (v["d"], v["fm"], v["ct"], t, 0.0, cs.TRAIN_CUTOFF)
    if per_sm is None:
        return swapped(cf, "PROJECT", src, lambda: cf.cheb_project_cuda(*args))
    fn = Kernel(src, cf.PROJECT.symbol, cf.PROJECT.argtypes)
    d, fm, ct = args[:3]
    e, c = d.numel(), ct.shape[-1]
    sms = torch.cuda.get_device_properties(d.device).multi_processor_count
    tiles = -(-c // 128) * -(-t // 64)
    chunks = min(-(-e // 256), max(1, -(-per_sm * sms // tiles)))

    def run():
        partial = torch.empty((chunks, t, c), device=d.device)
        out = torch.empty((t, c), device=d.device)
        fn(ptr(d), ptr(fm), ptr(ct), ptr(partial), ptr(out), e, t, c, chunks,
           0.0, cs.TRAIN_CUTOFF)
        return out
    return run


# kernel → the argument that names its source
KERNELS = {"edge_mlp": "edge_source", "blocked_mp_sum": "mp_source",
           "blocked_mp_dattr": "mp_source", "cheb_project": "cheb_source"}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--design", choices=("old", "new"), required=True)
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--edge-source", type=Path, default=CSRC / "edge_mlp.cu")
    ap.add_argument("--mp-source", type=Path, default=CSRC / "blocked_mp.cu")
    ap.add_argument("--cheb-source", type=Path,
                    default=CSRC / "cheb_filter.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dhfr_phases: CUDA is not available", file=sys.stderr)
        return 2
    kernels = args.kernels.split(",")
    if not set(kernels) <= set(KERNELS):
        raise SystemExit(f"--kernels: pick from {', '.join(KERNELS)}")
    cuts = OLD_CUTS if args.design == "old" else NEW_CUTS
    out = ROOT / "_checkout" / "dhfr_phases" / args.design
    forms = {}
    for key in kernels:
        source = getattr(args, KERNELS[key]).resolve()
        full = CudaSource(source.name)
        full.path = source
        forms[key] = {"full": full, **variants(source, cuts[key], out / key)}
    logs = build([src for f in forms.values() for src in f.values()])
    cs.emit({"phase": "build", "design": args.design, "kernels": kernels,
             "sources": {key: str(getattr(args, KERNELS[key]))
                         for key in kernels},
             "ptxas": {f"{key}/{name}": ptxas_table(
                 src.library_path().with_suffix(".log").read_text())
                 for key, f in forms.items() for name, src in f.items()},
             "logs": len(logs)})

    set_matmul_precision("highest")
    calls, plain, shapes = {}, {}, {}
    if {"edge_mlp", "blocked_mp_sum", "blocked_mp_dattr"} & set(kernels):
        dhfr, seg = cs.dhfr_system()
        pos = torch.as_tensor(dhfr[1], device="cuda")
        blocked = {}
        for layout, grouped in (("grouped", True), ("ungrouped", False)):
            spec = cs.dhfr_blocked_spec(dhfr, grouped)
            blocked[layout], _ = cs.dhfr_blocked_inputs(
                cs.BlockedDhfr(dhfr, seg, spec), pos, 66)
            v = blocked[layout]
            shapes[layout] = {"k": int(v["idx"].shape[1]),
                              "slots": int(v["mask"].numel()),
                              "valid_slots": int(v["mask"].sum())}
    if "edge_mlp" in forms:
        v4 = cs.dhfr_inputs(dhfr, seg, 55)
        mlp = {"brute": [v4["x"], v4["cw"], *v4["mlp"]],
               "grouped": [blocked["grouped"][k] for k in ("x", "cw")]
               + blocked["grouped"]["mlp"]}
        make4 = fused_old if args.design == "old" else fused_new
        for lst, w in mlp.items():
            plain[f"edge_mlp@{lst}"] = lambda w=w: em.edge_mlp_ref(*w)
            for name, src in forms["edge_mlp"].items():
                calls[f"edge_mlp@{lst}/{name}"] = make4(src, w)
            if args.design == "new":
                for name, plan in PLANS.items():
                    calls[f"edge_mlp@{lst}/{name}"] = fused_new(
                        forms["edge_mlp"]["full"], w, plan)
            shapes[f"edge_mlp@{lst}"] = {
                "slots": int(w[1].numel()), "live_slots": int((w[1] != 0).sum())}
    for key, make, ref, names in (
            ("blocked_mp_sum", sum_calls, bm.neighbor_sum_ref,
             ("attr", "feats", "idx", "mask")),
            ("blocked_mp_dattr", dattr_calls, bm.dattr_ref,
             ("g9", "feats", "idx", "mask"))):
        if key not in forms:
            continue
        for lst, v in blocked.items():
            plain[f"{key}@{lst}"] = (
                lambda a=tuple(v[n] for n in names), ref=ref: ref(*a))
            for name, src in forms[key].items():
                calls[f"{key}@{lst}/{name}"] = make(src, v)
    if "cheb_project" in forms:
        t = cs.TRAIN_T
        vp = cs.train_kernel_inputs(88)
        plain["cheb_project@train"] = lambda: cf.cheb_project_ref(
            vp["d"], vp["fm"], vp["ct"], t, 0.0, cs.TRAIN_CUTOFF)
        make6 = project_old if args.design == "old" else project_new
        for name, src in forms["cheb_project"].items():
            calls[f"cheb_project@train/{name}"] = make6(src, vp, t)
        if args.design == "new":
            for name, per_sm in PROJECT_PLANS.items():
                calls[f"cheb_project@train/{name}"] = project_new(
                    forms["cheb_project"]["full"], vp, t, per_sm)
        shapes["train"] = {"slots": int(vp["d"].numel()),
                           "live_slots": int((vp["fm"] != 0).sum()),
                           "t": t, "c": int(vp["ct"].shape[-1])}
    errs = {}
    for name, fn in calls.items():
        form = name.split("/")[1]
        if form in ("full", *PLANS, *PROJECT_PLANS, *VARIANTS):
            try:
                errs[name] = cs.compare(fn, plain[name.split("/")[0]])[1]
            except AssertionError as e:  # a non-finite output
                errs[name] = str(e)
    cs.emit({"phase": "vs_plain", "max_rel_err": errs, "shapes": shapes})
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
