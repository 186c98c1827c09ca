#!/usr/bin/env python3
"""Hold another build of the softmax-cross-entropy kernels' source against
this checkout's on one card: outputs bitwise or within the card's
tolerances, and each kernel's device time in turns (this, other, other,
this), as CUDA-graph replays that cycle through cold inputs.

    python3 tools/xent_ab.py OTHER.cu

OTHER.cu is a whole ``softmax_xent.cu`` with the same C interface, e.g. a
parent commit's (``git show HEAD~1:paddle_tpu_torch/csrc/softmax_xent.cu``),
kept in a directory that ``.gitignore`` lists.  It is built with the
checkout's nvcc flags into ``build/paddle_tpu_torch/ab/``.  Both builds are
called through their bare C entries on the same buffers, so their times
differ only in their kernels.  Three parts, one JSON line per case:

 - ``xent_ab_transformer``: the Transformer's 16,384 x 30,000, every entry
   (fp32, bf16 and fp16 logits; hard labels; soft labels in fp32 and in the
   logits' dtype), forward and backward: outputs bitwise equal;
 - ``xent_ab_narrow``: SSD's 122,688 x 21 and the R-CNN head's 1,024 x 81,
   every entry: loss and lse within ``ATOL`` / ``RTOL`` of the other
   build's, dx within ``DX_ATOL`` (fp32) or ``XENT_DX_ULPS`` ulp;
 - ``xent_ab_sweep``: V in {2, 21, 81, 128, 256, 1000, 4096, 30000} at SSD's
   2,576,448 logits (R = ceil(2,576,448 / V)), fp32, hard labels: the
   layout this build takes, outputs as above (bitwise on the wide layout),
   times beside ``F.cross_entropy``'s (forward, and forward + backward
   under autograd) and the bound.

Timed graphs cycle through input sets of ``chip_smoke.XENT_COLD_BYTES`` in
all (twice the 50 MB L2), as the bound assumes cold inputs.  Exits
non-zero if the card is missing, a build or launch fails, or an output
check fails; times are reported, not judged.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSD_LOGITS = 122688 * 21
SWEEP_V = (2, 21, 81, 128, 256, 1000, 4096, 30000)


def build_other(src):
    """The other source's library, built beside this checkout's headers."""
    from paddle_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "softmax_xent_other.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                           "-I", _build.CSRC, "-o", lib_path, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"xent_ab: nvcc failed for {src}:\n"
                         f"{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(lib_path)


def bind(lib):
    """``{(kind, sx, sy): entry}`` of a library, with the checkout's
    argument types."""
    from paddle_tpu_torch.ops import fused

    entries = {}
    for sx, sy in fused._XENT_ENTRIES:
        fwd = getattr(lib, f"pta_xent_fwd_{sx}_{sy}")
        bwd = getattr(lib, f"pta_xent_bwd_{sx}_{sy}")
        fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 3
                        + [ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_longlong, ctypes.c_void_p])
        bwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                        + [ctypes.c_void_p] * 4
                        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
        fwd.restype = bwd.restype = ctypes.c_int
        entries[("fwd", sx, sy)], entries[("bwd", sx, sy)] = fwd, bwd
    return entries


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream():
    import torch

    # the stream at call time: a graph's capture stream when captured
    return torch.cuda.current_stream().cuda_stream


class Case:
    """One input set of an entry: logits, labels, the backward's per-row
    inputs (from the plain version, so both builds get the same ones) and
    output buffers."""

    def __init__(self, gen, r, v, sx, sy, ignore):
        import torch

        from paddle_tpu_torch.ops import fused

        dev = torch.device("cuda", 0)
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                 "f16": torch.float16}[sx]
        self.soft, self.r, self.v = sy != "i64", r, v
        self.ignore = -100 if self.soft else ignore
        self.x = (torch.randn(r, v, generator=gen, device=dev) * 2).to(dtype)
        ids = torch.randint(0, v, (r,), generator=gen, device=dev)
        if self.soft:  # one_hot + label_smooth(0.1), as the programs build
            y = torch.zeros(r, v, device=dev).scatter_(
                1, ids[:, None], 1.0) * 0.9 + 0.1 / v
            self.lab = y.to(torch.float32 if sy == "f32" else dtype)
        else:
            ids[::7] = ignore
            self.lab = ids
        _, lse, sum_y = fused.softmax_xent_fwd_ref(self.x, self.lab,
                                                   self.soft, self.ignore)
        self.lse = lse.contiguous()
        self.g1, self.g2 = fused.xent_bwd_coeffs(
            self.lab, sum_y, torch.ones_like(lse), None, self.soft,
            self.ignore)
        self.out = {"loss": torch.empty(r, 1, device=dev),
                    "lse": torch.empty(r, 1, device=dev),
                    "sum_y": torch.empty(r, 1, device=dev),
                    "dx": torch.empty_like(self.x)}

    def call(self, entry, kind):
        soft = self.soft
        label = (None, _ptr(self.lab)) if not soft else (_ptr(self.lab),
                                                         None)
        if kind == "fwd":
            rc = entry(_ptr(self.x), label[0], label[1], int(soft),
                       _ptr(self.out["loss"]), _ptr(self.out["lse"]),
                       _ptr(self.out["sum_y"]) if soft else None, self.r,
                       self.v, self.ignore, _stream())
        else:
            rc = entry(_ptr(self.x), label[0], label[1], int(soft),
                       _ptr(self.lse), _ptr(self.g1), _ptr(self.g2),
                       _ptr(self.out["dx"]), self.r, self.v, _stream())
        if rc != 0:
            raise SystemExit(f"xent_ab: a {kind} launch failed: error {rc}")

    def outputs(self, kind):
        names = (("loss", "lse") + (("sum_y",) if self.soft else ())
                 if kind == "fwd" else ("dx",))
        return {n: self.out[n].clone() for n in names}


def cases(gen, r, v, sx, sy, ignore=0, cold=False):
    """One case, or (``cold``) enough for ``XENT_COLD_BYTES`` in all."""
    import chip_smoke as cs

    n = 1
    if cold:
        per = r * v * 4 * (2 if sy != "i64" else 1) + r * 8
        n = max(1, math.ceil(cs.XENT_COLD_BYTES / per))
    return [Case(gen, r, v, sx, sy, ignore) for _ in range(n)]


def compare(mine, theirs, kind, exact):
    """``(ok, report)``: the two builds' outputs of one case, bitwise
    (``exact``) or within the card's tolerances."""
    import torch

    import chip_smoke as cs

    report, ok = {}, True
    for name, got in mine.items():
        want = theirs[name]
        equal = bool(torch.equal(got, want))
        report[f"{name}_bitwise_equal"] = equal
        if exact:
            ok = ok and equal
        elif name == "dx" and got.dtype != torch.float32:
            report["dx_ulps"] = cs.ulp_err(got, want)
            ok = ok and report["dx_ulps"] <= cs.XENT_DX_ULPS
        else:
            diff = (got.float() - want.float()).abs()
            tol = (cs.DX_ATOL if name == "dx"
                   else cs.ATOL + cs.RTOL * want.float().abs())
            report[f"{name}_max_abs_err"] = float(diff.max())
            ok = ok and bool((diff <= tol).all())
    return ok, report


def turns(this, other, sets, kind):
    """Device ms of one call, this, other, other, this, from graph replays
    cycling through ``sets``."""
    import chip_smoke as cs

    def timed(entry):
        return cs.rotating_graph_ms(lambda c: c.call(entry, kind),
                                    [(c,) for c in sets])

    return [timed(this), timed(other), timed(other), timed(this)]


def run_case(this, other, sets, key, exact):
    """Both builds on the first set, compared; then the times."""
    import torch

    kind = key[0]
    c = sets[0]
    c.call(other[key], kind)
    torch.cuda.synchronize()
    theirs = c.outputs(kind)
    c.call(this[key], kind)
    torch.cuda.synchronize()
    ok, report = compare(c.outputs(kind), theirs, kind, exact)
    ms = turns(this[key], other[key], sets, kind)
    report["ms_this_other_other_this"] = ms
    report["this_over_other"] = (ms[0] + ms[3]) / (ms[1] + ms[2])
    report["ok"] = ok
    return ok, report


def layout(lib, case, kind):
    """The layout this build's ``kind`` entry takes for ``case``."""
    return ("wide", "narrow")[lib.pta_xent_layout(case.r, case.v,
                                                  int(kind == "bwd"))]


def library_ms(sets):
    """``F.cross_entropy`` (hard labels, ``ignore_index``) on the same
    sets: the forward, and the forward + backward under autograd."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs

    ones = torch.ones(sets[0].r, device=sets[0].x.device)
    leaves = [(c.x, c.lab, c.x.detach().requires_grad_()) for c in sets]

    def fwd(x, lab, _):
        return F.cross_entropy(x, lab, reduction="none", ignore_index=0)

    def pair(x, lab, xr):
        loss = F.cross_entropy(xr, lab, reduction="none", ignore_index=0)
        return torch.autograd.grad(loss, xr, ones)

    return {"library_fwd_ms": cs.rotating_graph_ms(fwd, leaves),
            "library_fwd_bwd_pair_ms": cs.rotating_graph_ms(pair, leaves)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another softmax_xent.cu")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import fused

    smi = cs.phase_device()
    lib = fused._lib("softmax_xent")
    this, other = bind(lib), bind(build_other(os.path.abspath(args.other)))
    gen = torch.Generator(device=torch.device("cuda", 0)).manual_seed(20)
    ok = True
    # the Transformer's shape: the wide layout, bitwise the other build's
    for sx, sy in fused._XENT_ENTRIES:
        sets = cases(gen, cs.TRAIN_BATCH * cs.TRAIN_LEN, cs.VOCAB, sx, sy)
        for kind in ("fwd", "bwd"):
            good, report = run_case(this, other, sets, (kind, sx, sy), True)
            ok = ok and good
            cs.emit("xent_ab_transformer", entry=f"{kind}_{sx}_{sy}",
                    rows=sets[0].r, vocab=sets[0].v,
                    layout=layout(lib, sets[0], kind), **report)
        del sets
        torch.cuda.empty_cache()
    # the detection paths' shapes, every entry, within the tolerances
    for name, r, v in (("ssd", cs.SSD_BATCH * cs.SSD_PRIORS, cs.SSD_CLASSES),
                       ("rcnn_heads", cs.RCNN_IMAGES * cs.RCNN_ROIS,
                        cs.RCNN_CLASSES)):
        for sx, sy in fused._XENT_ENTRIES:
            sets = cases(gen, r, v, sx, sy, cold=True)
            for kind in ("fwd", "bwd"):
                good, report = run_case(this, other, sets, (kind, sx, sy),
                                        False)
                ok = ok and good
                cs.emit("xent_ab_narrow", model=name, entry=f"{kind}_{sx}_"
                        f"{sy}", rows=r, classes=v, input_sets=len(sets),
                        layout=layout(lib, sets[0], kind), **report)
            del sets
            torch.cuda.empty_cache()
    # the sweep over V at SSD's logits, fp32, hard labels
    for v in SWEEP_V:
        r = math.ceil(SSD_LOGITS / v)
        sets = cases(gen, r, v, "f32", "i64", cold=True)
        line = {"v": v, "rows": r, "input_sets": len(sets)}
        for kind in ("fwd", "bwd"):
            took = layout(lib, sets[0], kind)
            good, report = run_case(this, other, sets, (kind, "f32", "i64"),
                                    took == "wide")
            ok = ok and good
            bound, by = cs.xent_bound_ms(r, v, False, kind == "bwd")
            line[kind] = {"layout": took, **report, "bound_ms": bound,
                          "bound_by": by}
        line.update(library_ms(sets))
        cs.emit("xent_ab_sweep", **line)
        del sets
        torch.cuda.empty_cache()
    print(smi)
    if not ok:
        raise SystemExit("xent_ab: an output differs beyond its tolerance")


if __name__ == "__main__":
    main()
