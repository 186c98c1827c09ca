#!/usr/bin/env python3
"""Hold another build of the flash kernels' source against this checkout's
on one card: every output of the forward, dQ and dK/dV kernels bitwise,
each kernel's device time in turns (this, other, other, this; from CUDA
graph replays), and the other build's registers and spill stores
(``chip_smoke.py``'s ``kernel_flash*`` phases report this one's), at the
training path's padding and causal cases (B 64, H 8, T 256, D 64), for
each dtype that both sources take (the fp32 entries always; the bf16 /
f16 ones where the other source has them).

    python3 tools/flash_ab.py OTHER.cu [--changed fwd:bf16,dkv:f16,...]

OTHER.cu is a whole ``flash_attention.cu`` with the same C interface, e.g.
a parent commit's (``git show HEAD~1:paddle_tpu_torch/csrc/
flash_attention.cu``, beside the headers it includes) or a variant of
this one, kept in a directory that ``.gitignore`` lists.  It is built with
the checkout's nvcc flags into ``build/paddle_tpu_torch/ab/``.  Every
kernel's outputs must be bitwise equal to the other build's, but those of
the kernels named in ``--changed`` (``KIND:DTYPE``, KIND ``fwd``, ``dq`` or
``dkv``), which must lie within ``chip_smoke.FLASH_LOW_TOL`` (bf16 / f16)
or ``FLASH_TOL`` (f32) of them instead.  One JSON line per dtype and case;
exits non-zero if the card is missing, a build or launch fails, or a
check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_other(src):
    """The other source's library and ptxas's report of its build."""
    from paddle_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "flash_attention_other.so")
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           lib_path, src], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"flash_ab: nvcc failed for {src}:\n{log}")
    return ctypes.CDLL(lib_path), log


def bind(lib, sfx):
    """The other library's three entries for dtype ``sfx``, with the
    checkout's argument types (None where it has no such entries)."""
    common = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p]
    tail = common if sfx == "f32" else common + [ctypes.c_int]
    entries = {}
    for kind, n_ptrs in (("fwd", 6), ("dq", 8), ("dkv", 9)):
        fn = getattr(lib, f"pta_flash_{kind}_{sfx}", None)
        if fn is None:
            return None
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + tail
        fn.restype = ctypes.c_int
        entries[kind] = fn
    return entries


#: the outputs of each kernel
OUTPUTS = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}


def within(got, want, name, sfx):
    """<= 0 where ``got`` lies within the card's tolerance of ``want``:
    ``FLASH_LOW_TOL`` for bf16 / f16 outputs, ``FLASH_TOL`` for lse and
    fp32 ones."""
    import chip_smoke as cs

    if sfx != "f32" and name != "lse":
        return cs.low_excess(got, want)
    atol, rtol = cs.FLASH_TOL[name]
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def compare(other, dtype, sfx, causal, changed):
    """One case: both builds' outputs from the same inputs, bitwise (or, for
    the kernels in ``changed``, within the tolerance), and their kernels'
    times in turns."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do, bias, _ = cs.flash_case_inputs(gen, dev, cs.TRAIN_LEN,
                                                cs.TRAIN_LEN, not causal)
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    scale = cs.FLASH_D ** -0.5
    bias2 = None if bias is None else bias.reshape(cs.TRAIN_BATCH,
                                                   -1).contiguous()
    def dims():
        # the stream at call time (a graph's capture stream when captured)
        d = [cs.TRAIN_BATCH, cs.FLASH_HEADS, cs.TRAIN_LEN, cs.TRAIN_LEN,
             cs.FLASH_D, scale, int(causal),
             torch.cuda.current_stream(dev).cuda_stream]
        return d if sfx == "f32" else d + [0]  # (the bias is fp32)

    out, lse = fa.flash_forward(q, k, v, bias, scale, causal)
    delta = fa._delta(out, do)
    mine = {"fwd": lambda: fa.flash_forward(q, k, v, bias, scale, causal),
            "dq": lambda: fa.flash_dq(q, k, v, bias, do, lse, delta, scale,
                                      causal),
            "dkv": lambda: fa.flash_dkv(q, k, v, bias, do, lse, delta,
                                        scale, causal)}
    got = {"out": out, "lse": lse, "dq": mine["dq"]()}
    got["dk"], got["dv"] = mine["dkv"]()
    theirs = {n: torch.empty_like(t) for n, t in got.items()}

    def ptrs(*ts):
        return [None if t is None else t.data_ptr() for t in ts]

    calls = {
        "fwd": lambda: other["fwd"](*ptrs(q, k, v, bias2, theirs["out"],
                                          theirs["lse"]), *dims()),
        "dq": lambda: other["dq"](*ptrs(q, k, v, bias2, do, lse, delta,
                                        theirs["dq"]), *dims()),
        "dkv": lambda: other["dkv"](*ptrs(q, k, v, bias2, do, lse, delta,
                                          theirs["dk"], theirs["dv"]),
                                    *dims())}
    for kind, call in calls.items():
        rc = call()
        if rc != 0:
            raise SystemExit(f"flash_ab: the other {kind} ({sfx}) failed to "
                             f"launch: error {rc}")
    torch.cuda.synchronize()
    # device times from CUDA-graph replays: this checkout's wrappers and the
    # other build's bare entries differ in host time, not in their kernels
    times = {kind: [cs.graph_time_ms(mine[kind]),
                    cs.graph_time_ms(calls[kind]),
                    cs.graph_time_ms(calls[kind]),
                    cs.graph_time_ms(mine[kind])] for kind in mine}
    result = {"bitwise_equal": {n: bool(torch.equal(got[n], theirs[n]))
                                for n in got},
              "ms_this_other_other_this": times, "changed": sorted(changed),
              "excess": {}}
    ok = True
    for kind, names in OUTPUTS.items():
        for n in names:
            if kind in changed:
                result["excess"][n] = within(got[n], theirs[n], n, sfx)
                ok = ok and result["excess"][n] <= 0
            else:
                ok = ok and result["bitwise_equal"][n]
    result["ok"] = ok
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another flash_attention.cu")
    ap.add_argument("--changed", default="",
                    help="KIND:DTYPE,... kernels held to the tolerance "
                         "instead of bitwise")
    args = ap.parse_args()
    changed = {}
    for item in filter(None, args.changed.split(",")):
        kind, sfx = item.split(":")
        if kind not in OUTPUTS:
            raise SystemExit(f"flash_ab: unknown kernel {kind!r}")
        changed.setdefault(sfx, set()).add(kind)
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    smi = cs.phase_device()
    lib, log = build_other(os.path.abspath(args.other))
    ok = True
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                       (torch.float16, "f16")):
        other = bind(lib, sfx)
        if other is None:
            continue
        for causal in (False, True):
            result = compare(other, dtype, sfx, causal,
                             changed.get(sfx, set()))
            ok = ok and result["ok"]
            cs.emit("flash_ab", other=args.other, dtype=sfx,
                    case="causal" if causal else "padding", **result)
        cs.emit("flash_ab_registers", dtype=sfx,
                other=cs.flash_registers(sfx, log))
    print(smi)
    if not ok:
        raise SystemExit("flash_ab: an output differs beyond what --changed "
                         "allows")


if __name__ == "__main__":
    main()
