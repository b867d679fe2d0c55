#!/usr/bin/env python3
"""Where kernels C and D of the PyTorch/CUDA port spend their time.

``ncu`` does not run on the card's machine, so this script attributes a
windowed-Coulomb kernel's device time by cutting one phase out of a copy
of its source at a time (a text edit each; a few edits instead try a
design variant), building every copy beside the original with ``nvcc``,
and timing them in turns with
``chip_smoke.device_ms`` at the north star's shapes (the 25,088-atom
lattice's real stencil windows at 10 + 1 Å, 48 charge channels,
``chip_smoke.blocked_inputs``).  A cut copy computes a wrong result; only
its time is read.  The original, and each copy that is a design variant
(not a cut), is held against the plain versions.

    python3 tools/torch_wc_phases.py --design new
    python3 tools/torch_wc_phases.py --design old \\
        --source PARENT/torchmdnet_tpu_torch/csrc/windowed_coulomb.cu

``--design old`` reads the SIMT ``wc_kernel<BWD>`` that the tensor-core
kernels replaced (a ``git archive`` of an earlier commit holds it) and
calls its C entry points as its wrapper did; ``--design new`` reads the
repository's source (or ``--source``) and calls it through
``ops/windowed_coulomb.py``.  The copies are written under
``_checkout/wc_phases/`` (git-ignored).  Each line of output is one JSON
object; the last holds the median device ms of every form.  Needs one
card.
"""

import argparse
import re
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from torchmdnet_tpu_torch.ops import windowed_coulomb as wc  # noqa: E402
from torchmdnet_tpu_torch.ops.coulomb import _rf_constants  # noqa: E402
from torchmdnet_tpu_torch.ops.kernels import (  # noqa: E402
    CSRC, F32, I32, I64, P, CudaSource, Kernel, build, ptr)

# cut → [(text of the source, its replacement)]; every text must occur
# exactly once.  "stage": the partner rows are staged for the first tile
# only; "copy": the same for the copy alone (the row search stays);
# "geometry": no pair geometry or G (a constant G); "channel": no Φ/S2
# channel sums; "pd": no pd channel sum (kernel D).
OLD_CUTS = {
    "stage": [("      if (tid < kP) {\n        int r = -1;",
               "      if (tid < kP && t0 == 0) {\n        int r = -1;"),
              ("for (int v = tid; v < np * p.ld; v += kThreads) {",
               "for (int v = tid; v < (t0 == 0 ? np * p.ld : 0); "
               "v += kThreads) {")],
    "copy": [("for (int v = tid; v < np * p.ld; v += kThreads) {",
              "for (int v = tid; v < (t0 == 0 ? np * p.ld : 0); "
              "v += kThreads) {")],
    "geometry": [("        float gv = 0.0f;\n        if (row_ok && "
                  "sRowIdx[pp] >= 0) {",
                  "        float gv = 1e-3f * pp;\n        if (false) {")],
    "channel": [("      for (int pp = 0; pp < np; ++pp) {\n        const "
                 "float gv = sG",
                 "      for (int pp = 0; pp < 0; ++pp) {\n        const "
                 "float gv = sG")],
    "pd": [("for (int c = 0; c < p.c; ++c) pd = fmaf(sWb[i * p.c + c], "
            "q[4 + c], pd);", "pd = sWb[i * p.c] * q[4];")],
}
# The tensor-core kernels.  Cuts: "stage", only the ring's first stages
# are copied (it then holds real rows; the other stages' barriers
# complete empty); "products", no Φ/S2 product (its B loads and
# mma.sync; the split G stays live); "pd", no pd product (kernel D); "g",
# no G or G′ (G = G′ = d); "compact", no G pass over the compacted pairs
# (G = d²: the compaction alone); "noskip", warp steps with no pair
# inside rc are not skipped (what the skip saves).  Design variants:
# "p64", 64 window rows a stage; "ring4", 64 rows a stage in a ring of
# four; "unroll_pd", D's pd product unrolled over all its channel tiles
# (not by 2); "fastexp", f_exp by __expf and a product with e; "divide",
# f_exp's division by e⁻¹ as an IEEE division.  (The p64 and ring4
# copies read the wrapper's rows, laid out for 128-row stages: right for
# one channel chunk, as at the north star.)
NEW_CUTS = {
    "stage": [("mbar_expect(bar, kP * kLdp * 4);",
               "mbar_expect(bar, seq + tt < kRing ? kP * kLdp * 4 : 0);\n"
               "        if (seq + tt >= kRing) return;")],
    "products": [("mma3(acc[n], ah, al, w0[c], w0[kLdp + c]);",
                  "acc[n][0] += __uint_as_float(ah[n & 3]) + "
                  "__uint_as_float(al[n & 3]) + (float)c;")],
    "pd": [("mma3(pd, ah, al, wr[k], wr[k + 4]);",
            "pd[kc & 3] += __uint_as_float(ah[kc & 3]) + "
            "__uint_as_float(al[kc & 3]);")],
    "g": [("g_and_grad(d, p, gv, gp);", "gv = gp = d;")],
    "compact": [("for (int k = lane; k < n_in; k += 32) {",
                 "for (int k = lane; k < 0; k += 32) {")],
    "noskip": [("if (!__any_sync(0xffffffffu, any)) continue;",
                "if (!__any_sync(0xffffffffu, any || true)) continue;")],
    "p64": [("constexpr int kP = 128; ", "constexpr int kP = 64; ")],
    "ring4": [("constexpr int kP = 128; ", "constexpr int kP = 64; "),
              ("constexpr int kRing = 3; ", "constexpr int kRing = 4; ")],
    "unroll_pd": [("#pragma unroll 2\n            for (int kc = 0;",
                   "#pragma unroll\n            for (int kc = 0;")],
    "fastexp": [("const float fexp = div_inv_e(expf(-r_one_m));",
                 "const float fexp = __expf(-r_one_m) * (1.0f / kInvE);")],
    "divide": [("const float fexp = div_inv_e(expf(-r_one_m));",
                "const float fexp = expf(-r_one_m) / kInvE;")],
}
VARIANTS = ("p64", "ring4", "unroll_pd", "fastexp", "divide")
OLD_TAIL = [I64, I32, I32, I32] + [F32] * 7


def variants(source: Path, cuts: dict, out: Path):
    """A ``CudaSource`` for each cut copy of ``source`` (with the shared
    headers beside it, where ``nvcc`` resolves its includes)."""
    text = source.read_text()
    made = {}
    for name, edits in cuts.items():
        body = text
        for old, new in edits:
            if body.count(old) != 1:
                raise SystemExit(f"cut {name}: {old[:50]!r} occurs "
                                 f"{body.count(old)} times")
            body = body.replace(old, new)
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for header in CSRC.glob("*.cuh"):
            shutil.copy(header, d / header.name)
        (d / source.name).write_text(f"// phase cut: {name}\n" + body)
        src = CudaSource(source.name)
        src.path = d / source.name
        made[name] = src
    return made


def ptxas_table(log: str) -> dict:
    """Each kernel's (registers, spill-store bytes) from ``ptxas -v``,
    named by its template arguments where it has them (``bwd6`` for
    ``<true, 6>``)."""
    table, name = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            fn = ln.split("for ")[-1].strip()
            m = re.search(r"I(?:Lb(\d)E)?(?:Li(\d+)E)?",
                          fn.split("kernel")[-1])
            name = fn.split("kernel")[0].split("_")[-1] + "kernel"
            if m and (m.group(1) or m.group(2)):
                name = ("bwd" if m.group(1) == "1" else "fwd") + (m.group(2)
                                                                 or "")
            table[name] = [None, None]
        elif name and "spill stores" in ln:
            table[name][1] = int(ln.split("bytes spill stores")[0]
                                 .split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            table[name][0] = int(ln.split("Used ")[1].split()[0])
    return table


def old_calls(src: CudaSource, w, rc, eps, factor):
    """Kernels C and D of the old source, called as their wrapper did:
    one [n, 4 + C] row source (x, y, z, ct or 0, b)."""
    fwd = Kernel(src, "tmd_windowed_coulomb_fwd", [P] * 7 + OLD_TAIL)
    bwd = Kernel(src, "tmd_windowed_coulomb_bwd", [P] * 9 + OLD_TAIL)
    cwin, pos, b = w["cwin"], w["pos_s"], w["b_s"]
    k_rf, c_rf = _rf_constants(rc, eps)
    nb, nsc = cwin.a1.shape
    tail = [nb, cwin.cap, nsc, b.shape[1], *cwin.box_host, rc * rc, k_rf,
            c_rf, factor]
    ptrs = [ptr(t) for t in (cwin.a1, cwin.e1, cwin.a2, cwin.e2,
                             cwin.row_valid)]

    def run_fwd():
        src_rows = torch.cat([pos, torch.zeros_like(pos[:, :1]), b], dim=1)
        phi = torch.empty_like(b)
        fwd(ptr(src_rows), *ptrs, ptr(phi), *tail)
        return phi

    def run_bwd():
        src_rows = torch.cat([pos, w["ct"][:, None], b], dim=1)
        dpos, s2 = torch.empty_like(pos), torch.empty_like(b)
        bwd(ptr(src_rows), *ptrs, ptr(w["qw"]), ptr(s2), ptr(dpos), *tail)
        return dpos, s2
    return run_fwd, run_bwd


def new_calls(src: CudaSource, w, rc, eps, factor):
    """Kernels C and D of ``src`` through ``ops/windowed_coulomb.py``."""
    fwd = Kernel(src, wc.FORWARD.symbol, wc.FORWARD.argtypes)
    bwd = Kernel(src, wc.BACKWARD.symbol, wc.BACKWARD.argtypes)
    args = (w["pos_s"], w["b_s"])
    consts = (rc, eps, factor)

    def swapped(fn, *a):
        saved = wc.FORWARD, wc.BACKWARD
        wc.FORWARD, wc.BACKWARD = fwd, bwd
        try:
            return fn(*a)
        finally:
            wc.FORWARD, wc.BACKWARD = saved

    return (lambda: swapped(wc.wc_fwd_cuda, *args, w["cwin"], *consts),
            lambda: swapped(wc.wc_bwd_cuda, *args, w["ct"], w["qw"],
                            w["cwin"], *consts))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--design", choices=("old", "new"), required=True)
    ap.add_argument("--source", type=Path,
                    default=CSRC / "windowed_coulomb.cu")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_wc_phases: CUDA is not available", file=sys.stderr)
        return 2
    cuts = OLD_CUTS if args.design == "old" else NEW_CUTS
    out = ROOT / "_checkout" / "wc_phases" / args.design
    full = CudaSource(args.source.name)
    full.path = args.source.resolve()
    forms = {"full": full, **variants(args.source, cuts, out)}
    build(list(forms.values()))
    logs = {name: src.library_path().with_suffix(".log").read_text()
            for name, src in forms.items()}
    cs.emit({"phase": "build", "design": args.design,
             "source": str(args.source),
             "ptxas": {name: ptxas_table(log) for name, log in logs.items()}})

    _, pos, _, _, L = cs.northstar_system()
    rc = cs.COULOMB_RC + cs.SKIN
    eps, factor = 78.3, 7.2
    spec, wspec, _, w = cs.blocked_inputs(
        pos, L, cs.CAP, cs.K, cs.F, cs.Q_TAB, cs.C_CH, 4.5 + cs.SKIN, rc, 77)
    make = old_calls if args.design == "old" else new_calls
    calls = {name: make(src, w, rc, eps, factor) for name, src in
             forms.items()}
    plain = (lambda: wc.wc_fwd_ref(w["pos_s"], w["b_s"], w["cwin"], rc, eps,
                                   factor),
             lambda: wc.wc_bwd_ref(w["pos_s"], w["b_s"], w["ct"], w["qw"],
                                   w["cwin"], rc, eps, factor))
    errs = {}
    for name, pair in calls.items():
        if name in ("full", *VARIANTS):
            for kind, kern, ref in zip(("fwd", "bwd"), pair, plain):
                try:
                    errs[f"{name}/{kind}"] = cs.compare(kern, ref)[1]
                except AssertionError as e:  # a non-finite output
                    errs[f"{name}/{kind}"] = str(e)
    cs.emit({"phase": "vs_plain", "max_rel_err": errs,
             "blocks": spec.n_blocks, "stencil_s": wspec.s,
             "channels": cs.C_CH})
    times = {}
    for _ in range(args.rounds):
        for name, (f, b) in calls.items():
            times.setdefault(f"{name}/fwd", []).append(cs.device_ms(f))
            times.setdefault(f"{name}/bwd", []).append(cs.device_ms(b))
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    cs.emit({"phase": "device_ms", "design": args.design, "nvidia_smi": smi,
             "device_ms": times})
    return 0


if __name__ == "__main__":
    sys.exit(main())
