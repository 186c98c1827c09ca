"""The training guardian (counterpart of ``paddle_tpu/fluid/guardian.py``):
a numerics sentinel over every guarded step, a commit gate on the device,
a policy per trip, a flight recorder, and a replay of a recorded step.

A program built by ``Optimizer.minimize`` runs guarded when a
:class:`Guardian` is armed (:func:`enable`, or ``PADDLE_TPU_GUARDIAN``),
or when it was built under ``fluid.amp`` dynamic loss scaling (the scale
vars ``amp.LOSS_SCALE_VAR`` / ``amp.LOSS_SCALE_GOOD_VAR``):

 - **seed**: the ``__loss_seed__`` op's output is multiplied by
   :func:`seed_multiplier`: the loss scale (if any) times the fault
   layer's grad-Inf injection (``PADDLE_FAULT_GRAD_INF_STEP``, normally
   1), on the device, so an injected Inf flows through the real grad ops;
 - **health** (:func:`fold_health`): the loss times the injected spike
   factor (``PADDLE_FAULT_LOSS_SPIKE_STEP``, normally 1), the global
   grad norm (divided by the scale), ``finite`` (the loss and every raw
   grad) and ``ok = finite and loss <= loss_cap``, as 0-d device tensors;
 - **commit gate**: every read-write persistable the step updated
   (parameters, moments, beta pows, batch-norm statistics, step counters)
   is committed as ``torch.where(ok, new, old)``, so a tripped step leaves
   the state bitwise as it was; the RNG and the scale vars still advance;
   the scale halves on a non-finite step (never below 1) and doubles
   after ``growth_interval`` good ones;
 - **one step late**: at the end of step k the health scalars are copied
   without blocking into pinned host memory and an event is recorded; at
   the next step boundary the host waits on that event (the copy has long
   landed by then: an eager step is host-bound) and applies the policy
   before step k+1 runs.  ``Guardian.boundary_waits_s`` keeps each wait.
   A ``run_steps`` window folds its steps' health into the reference's
   aggregate (:func:`window_health_init`, :func:`window_health_update`:
   the first tripped step, the worst values, the count of bad steps) in
   static buffers the CUDA graph updates; the sentinel's per-step inputs
   (``seed_mul``, ``loss_mul``) and the window's ``loss_cap`` are static
   input buffers written before each replay, never constants of the
   capture;
 - **policy**: ``skip`` (count it and go on), ``halt`` (raise
   :class:`NumericsTripped`), ``dump_and_halt`` (write a replay bundle,
   then raise); every trip under ``PADDLE_ELASTIC_INCIDENTS`` appends one
   JSON line there;
 - **flight recorder**: the last ``ring_size`` health records, and the
   clean losses of the last ``spike_window`` records, whose median times
   ``spike_factor`` is the next step's ``loss_cap``
   (:meth:`FlightRecorder.loss_cap`: inf until 4 clean losses exist);
 - **replay**: ``python -m paddle_tpu_torch.fluid.guardian replay
   <bundle>`` re-executes the recorded step from the bundle's pre-step
   state and feeds, on the device kind that wrote it (``--place`` picks
   another), checks that the loss reproduces the recorded bits, then
   walks the block op by op to name the first variable that went
   non-finite.

Without an armed guardian a loss-scaled program keeps the scaler's host
gate in ``Executor.run``: one host read of the finite flag a step, the
``Optimize`` ops skipped on overflow (bitwise the device gate).

Knobs (``fluid.envcontract``)::

    PADDLE_TPU_GUARDIAN=skip|halt|dump_and_halt   arm the sentinel (1 = skip)
    PADDLE_TPU_GUARDIAN_SPIKE=f      loss-spike factor (0 disables)
    PADDLE_TPU_GUARDIAN_WINDOW=w     spike window (default 32 steps)
    PADDLE_TPU_GUARDIAN_RING=k       flight-recorder depth (default 128)
    PADDLE_TPU_GUARDIAN_DIR=path     replay-bundle directory
                                     (default ./guardian_dumps)

The reference's profiler counters (``guardian_steps``, ``guardian_trips``,
...) and its run-event stream come with ``observe`` (``ROADMAP.md`` queue
1 item 9); :meth:`Guardian.metrics` holds the same counts.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "NumericsTripped", "GuardianConfig", "Guardian", "HealthRecord",
    "FlightRecorder", "GuardSpec", "enable", "disable", "install", "current",
    "for_program", "metrics", "flush", "replay", "seed_multiplier",
    "finite_flag", "step_finite", "fold_health", "window_health_init",
    "window_health_update",
]

POLICIES = ("skip", "halt", "dump_and_halt")

BUNDLE_META = "meta.json"
BUNDLE_PROGRAM = "program.pkl"
BUNDLE_FEEDS = "feeds.npz"
BUNDLE_STATE = "state.npz"
BUNDLE_RECORDS = "records.json"
# the generator's state in a bundle's state file (uint8, torch's layout)
_RNG_KEY = "@RNG_STATE@"


def _log(msg: str) -> None:
    sys.stderr.write(f"guardian: {msg}\n")
    sys.stderr.flush()


class NumericsTripped(RuntimeError):
    """Raised by the ``halt`` / ``dump_and_halt`` policies; carries the
    offending :class:`HealthRecord` and, when dumped, the bundle path."""

    def __init__(self, record: "HealthRecord", bundle: Optional[str] = None):
        self.record = record
        self.bundle = bundle
        msg = (f"numerics sentinel tripped at step {record.step}: "
               f"loss={record.loss!r} grad_norm={record.grad_norm!r} "
               f"finite={record.finite} spike={record.spike}")
        if bundle:
            msg += f" (replay bundle: {bundle})"
        super().__init__(msg)


class GuardianConfig:
    def __init__(self, policy: str = "skip", spike_factor: float = 0.0,
                 spike_window: int = 32, ring_size: int = 128,
                 bundle_dir: Optional[str] = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, "
                             f"got {policy!r}")
        self.policy = policy
        self.spike_factor = float(spike_factor)
        self.spike_window = max(2, int(spike_window))
        self.ring_size = max(2, int(ring_size))
        self.bundle_dir = bundle_dir or os.path.join(os.getcwd(),
                                                     "guardian_dumps")

    @classmethod
    def from_env(cls, env=None) -> Optional["GuardianConfig"]:
        """``PADDLE_TPU_GUARDIAN*`` of ``env`` (default: the process
        environment), each through its ``fluid.envcontract`` declaration;
        None when the guardian is not armed."""
        from . import envcontract as _ec

        env = os.environ if env is None else env

        def val(name):
            return _ec.REGISTRY[name].parse(env.get(name))

        policy = (val("PADDLE_TPU_GUARDIAN") or "").strip().lower()
        if not policy or policy in ("0", "off", "false"):
            return None
        if policy in ("1", "true", "on"):
            policy = "skip"
        return cls(policy=policy,
                   spike_factor=val("PADDLE_TPU_GUARDIAN_SPIKE"),
                   spike_window=val("PADDLE_TPU_GUARDIAN_WINDOW"),
                   ring_size=val("PADDLE_TPU_GUARDIAN_RING"),
                   bundle_dir=val("PADDLE_TPU_GUARDIAN_DIR"))


class HealthRecord:
    """One step's health, as the host observes it one step late."""

    __slots__ = ("step", "loss", "grad_norm", "scale", "finite", "ok",
                 "spike", "duration_s")

    def __init__(self, step, loss, grad_norm, scale, finite, ok, spike,
                 duration_s=0.0):
        self.step = int(step)
        self.loss = float(loss)
        self.grad_norm = float(grad_norm)
        self.scale = float(scale)
        self.finite = bool(finite)
        self.ok = bool(ok)
        self.spike = bool(spike)
        self.duration_s = float(duration_s)

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class FlightRecorder:
    """The last K health records and the spike statistics."""

    def __init__(self, size: int, spike_window: int):
        self.ring: deque = deque(maxlen=size)
        self._recent_losses: deque = deque(maxlen=spike_window)

    def append(self, rec: HealthRecord) -> None:
        self.ring.append(rec)
        if rec.ok and math.isfinite(rec.loss):
            self._recent_losses.append(rec.loss)

    def records(self) -> List[HealthRecord]:
        return list(self.ring)

    def loss_cap(self, spike_factor: float) -> float:
        """The spike threshold fed into the next step's commit gate: inf
        until 4 clean losses exist."""
        if spike_factor <= 0 or len(self._recent_losses) < 4:
            return float("inf")
        med = statistics.median(self._recent_losses)
        if med <= 0 or not math.isfinite(med):
            return float("inf")
        return spike_factor * med


# ---------------------------------------------------------------------------
# Per-program guard spec and the device-side health fold
# ---------------------------------------------------------------------------


class GuardSpec:
    """Static description of how to guard one training Program."""

    def __init__(self, loss_name: str, grad_names: List[str],
                 scale_vars, growth_interval: int):
        self.loss_name = loss_name
        self.grad_names = list(grad_names)
        self.scale_vars = tuple(scale_vars) if scale_vars else None
        self.growth_interval = int(growth_interval)

    def extra_fetch_names(self) -> List[str]:
        return [self.loss_name] + self.grad_names

    def cache_token(self):
        return ("guard", self.loss_name, tuple(self.grad_names),
                self.scale_vars, self.growth_interval)


def for_program(program) -> Optional[GuardSpec]:
    """GuardSpec when ``program`` runs guarded: a training program (params
    and grads and a recorded loss) while a guardian is armed, or one built
    with dynamic loss scaling."""
    if getattr(program, "_params_grads", None) is None:
        return None
    loss_name = getattr(program, "_loss_name", None)
    if not loss_name:
        return None
    scale_vars = getattr(program, "_loss_scale_vars", None)
    if current() is None and scale_vars is None:
        return None
    grad_names = [g.name for _, g in program._params_grads if g is not None]
    if not grad_names:
        return None
    return GuardSpec(loss_name, grad_names, scale_vars,
                     getattr(program, "_loss_scale_growth", 1000))


def _scalar(v, device, dtype=torch.float32) -> torch.Tensor:
    """A sentinel input as a 0-d tensor on ``device``: a tensor as it is
    (a window's static buffer), a host number by a device fill (no host
    to device copy)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(())
    return torch.full((), float(np.float32(v)), dtype=dtype, device=device)


def seed_multiplier(spec: GuardSpec, state: Dict, sentinel: Dict,
                    device=None):
    """The fp32 0-d tensor (on ``device``, or the scale's) the backward
    seed is multiplied by: the injected grad-Inf factor (normally 1) times
    the dynamic loss scale (when the program has one)."""
    ref = state[spec.scale_vars[0]] if spec.scale_vars else None
    if ref is not None:
        device = ref.device
    mul = _scalar(sentinel["seed_mul"], device)
    if ref is not None:
        mul = mul * ref.reshape(()).float()
    return mul


def finite_flag(loss, grads) -> torch.Tensor:
    """A 0-d bool device tensor: the loss and every raw grad are finite."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(g).all() for g in grads if g.numel()]
    return torch.stack(flags).all()


def step_finite(loss, grads) -> bool:
    """:func:`finite_flag` read on the host: one device synchronization."""
    return bool(finite_flag(loss, grads))


def _grad_norm(grads, device) -> torch.Tensor:
    grads = [g.float() for g in grads if g.numel()]
    if not grads:
        return torch.zeros((), dtype=torch.float32, device=device)
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


def fold_health(spec: GuardSpec, extra_fetches, new_state: Dict,
                mut_state: Dict, state: Dict, sentinel: Dict, finite=None):
    """The health reduction, the commit gate and the loss-scale update of
    one step; returns ``(committed, health)``.

    ``extra_fetches``: the loss and the raw grads (``spec``'s extra
    fetches) as the step left them; ``new_state``: the step's persistable
    outputs; ``mut_state``: the values the step started from for the
    read-write ones; ``state``: what the step read (the scale vars among
    it); ``sentinel``: ``loss_cap``, ``seed_mul``, ``loss_mul`` (host
    numbers, or 0-d tensors a window writes before each step).  Health is
    a dict of 0-d device tensors (``loss``, ``grad_norm``, ``finite``,
    ``ok``, ``scale``); the commit is ``torch.where(ok, new, old)``.

    ``finite``: a host bool the caller already read (the loss scaler's
    host gate, no guardian): the commit and the scale update branch on
    the host, bitwise the device gate's values, and health is None."""
    from .framework import RNG_STATE_VAR

    loss_raw = extra_fetches[0]
    grads = extra_fetches[1:]
    device = loss_raw.device
    skip_revert = {RNG_STATE_VAR}
    if spec.scale_vars is not None:
        skip_revert.update(spec.scale_vars)
    host = isinstance(finite, bool)
    if host:
        ok = finite
        health = None
    else:
        loss = loss_raw.reshape(-1)[0].float()
        # the injected loss spike (the spike detector's oracle)
        health_loss = loss * _scalar(sentinel["loss_mul"], device)
        finite = finite_flag(health_loss, grads)
        grad_norm = _grad_norm(grads, device)
        # NaN compares False against any cap: one predicate covers both
        ok = finite & (health_loss <= _scalar(sentinel["loss_cap"], device))
    committed = {}
    for name, val in new_state.items():
        old = mut_state.get(name)
        if old is None or name in skip_revert:
            # write-only vars (a decayed lr), the RNG and the scaler state
            # (updated below) keep the new value; every read-write var
            # reverts on a bad step
            committed[name] = val
        elif host:
            committed[name] = val if ok else old
        else:
            committed[name] = torch.where(ok, val, old)
    scale = None
    if spec.scale_vars is not None:
        scale_name, good_name = spec.scale_vars
        s_old, g_old = state[scale_name], state[good_name]
        scale = s_old.reshape(()).float()
        good = g_old.reshape(()).to(torch.int32)
        if host:
            new_good = good + 1 if finite else torch.zeros_like(good)
            grow = new_good >= spec.growth_interval
            new_scale = (torch.where(grow, scale * 2.0, scale) if finite
                         else torch.clamp_min(scale * 0.5, 1.0))
        else:
            # raw grads carry the loss scale: report the true norm
            grad_norm = grad_norm / scale
            new_good = torch.where(finite, good + 1, torch.zeros_like(good))
            grow = new_good >= spec.growth_interval
            new_scale = torch.where(finite,
                                    torch.where(grow, scale * 2.0, scale),
                                    torch.clamp_min(scale * 0.5, 1.0))
        new_good = torch.where(grow, torch.zeros_like(new_good), new_good)
        committed[scale_name] = new_scale.reshape(s_old.shape).to(s_old.dtype)
        committed[good_name] = new_good.reshape(g_old.shape).to(g_old.dtype)
        scale = new_scale
    if not host:
        if scale is None:
            scale = torch.ones((), dtype=torch.float32, device=device)
        health = {"loss": health_loss, "grad_norm": grad_norm,
                  "finite": finite, "ok": ok, "scale": scale}
    return committed, health


def window_health_init(n_steps: int, device=None) -> Dict[str, torch.Tensor]:
    """The aggregate health of a ``run_steps`` window before its first
    step: no trip (``trip_idx == n_steps``), nothing bad, the worst loss
    -inf.  A window folds every step into it
    (:func:`window_health_update`) and the host reads it once."""
    f32 = torch.float32

    def full(v, dtype=f32):
        return torch.full((), v, dtype=dtype, device=device)

    return {"trip_idx": full(n_steps, torch.int32),
            "trip_loss": full(0.0), "trip_grad_norm": full(0.0),
            "trip_finite": full(True, torch.bool),
            "bad_steps": full(0, torch.int32),
            "worst_loss": full(-math.inf), "worst_grad_norm": full(0.0),
            "all_finite": full(True, torch.bool), "scale": full(1.0)}


def window_health_update(agg, health, step_i, n_steps):
    """Fold one step's health into the window aggregate: the FIRST tripped
    step (its index and values), the worst values anywhere (a NaN loss
    makes the worst loss NaN), the count of bad steps.  ``step_i`` and
    ``n_steps``: ints, or 0-d int tensors a graphed window writes before
    each step."""
    ok = health["ok"]
    first = (agg["trip_idx"] == n_steps) & ~ok
    step = step_i.to(torch.int32) if isinstance(step_i, torch.Tensor) \
        else torch.full((), int(step_i), dtype=torch.int32,
                        device=ok.device)
    return {
        "trip_idx": torch.where(first, step, agg["trip_idx"]),
        "trip_loss": torch.where(first, health["loss"], agg["trip_loss"]),
        "trip_grad_norm": torch.where(first, health["grad_norm"],
                                      agg["trip_grad_norm"]),
        "trip_finite": torch.where(first, health["finite"],
                                   agg["trip_finite"]),
        "bad_steps": agg["bad_steps"] + (~ok).to(torch.int32),
        "worst_loss": torch.maximum(agg["worst_loss"], health["loss"]),
        "worst_grad_norm": torch.maximum(agg["worst_grad_norm"],
                                         health["grad_norm"]),
        "all_finite": agg["all_finite"] & health["finite"],
        "scale": health["scale"],
    }


class HealthCopy:
    """A step's (or window's) health scalars on their way to the host: one
    non-blocking copy into pinned memory and an event on the card; read on
    the CPU as they are."""

    def __init__(self, health: Dict[str, torch.Tensor]):
        self.keys = list(health)
        vals = torch.stack([health[k].reshape(()).to(torch.float64)
                            for k in self.keys])
        self.event = None
        if vals.device.type == "cuda":
            self.host = torch.empty(vals.shape, dtype=torch.float64,
                                    pin_memory=True)
            self.host.copy_(vals, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = vals

    def read(self):
        """``({key: float}, seconds the host waited for the copy)``."""
        t0 = time.perf_counter()
        if self.event is not None:
            self.event.synchronize()
        waited = time.perf_counter() - t0
        vals = self.host.tolist()
        return dict(zip(self.keys, vals)), waited


# ---------------------------------------------------------------------------
# The host-side guardian (a module singleton, armed like fluid.fault)
# ---------------------------------------------------------------------------


_UNSET = object()
_guardian = _UNSET


class Guardian:
    def __init__(self, config: GuardianConfig):
        self.config = config
        self.recorder = FlightRecorder(config.ring_size, config.spike_window)
        self.counters = {"steps": 0, "trips": 0, "skips": 0, "halts": 0,
                         "spikes": 0, "nonfinite": 0}
        self._pending = None  # (spec, step, health, ctx)
        self.last_scale = 1.0
        #: the host's wait for each observed record's copy, in seconds
        self.boundary_waits_s: List[float] = []

    # -- step plumbing (called by the Executor) --
    def loss_cap(self) -> float:
        return self.recorder.loss_cap(self.config.spike_factor)

    def on_boundary(self) -> None:
        """A step boundary: observe the PREVIOUS step's health and apply
        the policy before the next step runs."""
        self._check_pending()

    def defer(self, spec, step, health, ctx) -> None:
        """Queue a dispatch's health (a :class:`HealthCopy`) for the next
        boundary.  ``step``: the dispatch's first step; a window
        (``ctx["window"]``) carries its aggregate."""
        self._pending = (spec, step, health, ctx)
        self.counters["steps"] += (ctx.get("window") or {}).get("n_steps", 1)

    def flush(self) -> None:
        """Check the deferred record now (after the last training step;
        the Trainer does this)."""
        self._check_pending()

    # -- observation and policy --
    def _check_pending(self) -> None:
        if self._pending is None:
            return
        spec, step, health, ctx = self._pending
        self._pending = None
        h, waited = health.read()
        self.boundary_waits_s.append(waited)
        win = ctx.get("window")
        if win is not None:
            # the record of a window: its FIRST tripped step, or on a
            # clean window its last step with the worst values seen
            n = int(win["n_steps"])
            trip_idx = int(h["trip_idx"])
            tripped = trip_idx < n
            win["trip_offset"] = trip_idx if tripped else None
            win["bad_steps"] = int(h["bad_steps"])
            rec = HealthRecord(
                step=step + (trip_idx if tripped else n - 1),
                loss=h["trip_loss" if tripped else "worst_loss"],
                grad_norm=h["trip_grad_norm" if tripped
                            else "worst_grad_norm"],
                scale=h["scale"],
                finite=bool(h["trip_finite" if tripped else "all_finite"]),
                ok=not tripped, spike=False,
                duration_s=ctx.get("duration_s", 0.0))
        else:
            rec = HealthRecord(step=step, loss=h["loss"],
                               grad_norm=h["grad_norm"], scale=h["scale"],
                               finite=bool(h["finite"]), ok=bool(h["ok"]),
                               spike=False,
                               duration_s=ctx.get("duration_s", 0.0))
        rec.spike = rec.finite and not rec.ok
        self.recorder.append(rec)
        self.last_scale = rec.scale
        if rec.ok:
            return
        self._trip(rec, spec, ctx)

    def _trip(self, rec: HealthRecord, spec: GuardSpec, ctx: dict) -> None:
        self.counters["trips"] += 1
        self.counters["nonfinite" if not rec.finite else "spikes"] += 1
        policy = self.config.policy
        bundle = None
        if policy == "dump_and_halt":
            try:
                bundle = self.dump_bundle(rec, spec, ctx)
            except Exception as exc:
                _log(f"replay-bundle dump failed: {exc!r}")
        self._incident(rec, policy, bundle, window=ctx.get("window"))
        if policy == "skip":
            self.counters["skips"] += 1
            _log(f"step {rec.step} tripped (loss={rec.loss!r}, "
                 f"grad_norm={rec.grad_norm!r}): update dropped, training "
                 f"continues")
            return
        self.counters["halts"] += 1
        raise NumericsTripped(rec, bundle)

    def _incident(self, rec: HealthRecord, policy: str,
                  bundle: Optional[str], window: Optional[dict] = None):
        """One JSON line in ``PADDLE_ELASTIC_INCIDENTS`` (when set) per
        trip, with the window's extent and bad steps for a window."""
        from . import envcontract

        path = envcontract.get("PADDLE_ELASTIC_INCIDENTS")
        if not path:
            return
        fields = {"ts": time.time(), "event": "guardian_trip",
                  "step": rec.step, "policy": policy, "loss": rec.loss,
                  "grad_norm": rec.grad_norm, "scale": rec.scale,
                  "finite": rec.finite, "spike": rec.spike, "bundle": bundle,
                  "rank": envcontract.get("PADDLE_TRAINER_ID")}
        if window is not None:
            fields.update(window_start=window["start"],
                          window_steps=window["n_steps"],
                          window_bad_steps=window.get("bad_steps"))
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps(fields) + "\n")
        except OSError:
            pass  # reporting must never mask the trip itself

    # -- flight-recorder dump --
    def dump_bundle(self, rec: HealthRecord, spec: GuardSpec,
                    ctx: dict) -> str:
        """Write the replay bundle of a tripped step (or window): the
        program, the feeds, the pre-step state (the generator's state
        under ``@RNG_STATE@``), the sentinel's inputs, the ring."""
        root = self.config.bundle_dir
        os.makedirs(root, exist_ok=True)
        bdir = os.path.join(root, f"step_{rec.step}")
        n = 1
        while os.path.exists(bdir):
            bdir = os.path.join(root, f"step_{rec.step}.{n}")
            n += 1
        os.makedirs(bdir)

        def host(v):
            if isinstance(v, torch.Tensor):
                v = v.detach()
                if v.dtype == torch.bfloat16:
                    v = v.float()
                return v.cpu().numpy()
            return np.asarray(v)

        program = ctx["program"]
        with open(os.path.join(bdir, BUNDLE_PROGRAM), "wb") as f:
            f.write(program.serialize_to_string())
        with open(os.path.join(bdir, BUNDLE_FEEDS), "wb") as f:
            np.savez(f, **{k: host(v) for k, v in ctx["feeds"].items()})
        state = {k: host(v) for k, v in ctx["state"].items()}
        if ctx.get("rng_state") is not None:
            state[_RNG_KEY] = ctx["rng_state"].numpy()
        with open(os.path.join(bdir, BUNDLE_STATE), "wb") as f:
            np.savez(f, **state)

        def sent_json(v):
            a = np.asarray(host(v), np.float32)
            return a.tolist() if a.ndim else float(a)

        meta = {
            "step": rec.step,
            "loss": rec.loss,
            "loss_bits": np.float32(rec.loss).tobytes().hex(),
            "grad_norm": rec.grad_norm,
            "scale": rec.scale,
            "finite": rec.finite,
            "spike": rec.spike,
            "device": ctx.get("device", "cpu"),
            "amp": ctx.get("amp"),
            "fetch_names": list(ctx.get("fetch_names", [])),
            "extra_fetch_names": spec.extra_fetch_names(),
            "scale_vars": list(spec.scale_vars) if spec.scale_vars else None,
            "growth_interval": spec.growth_interval,
            "sentinel": {k: sent_json(v)
                         for k, v in ctx["sentinel"].items()},
            "feed_lods": {k: [list(map(int, lv)) for lv in lod]
                          for k, lod in (ctx.get("feed_lods") or {}).items()},
        }
        win = ctx.get("window")
        if win is not None:
            # the state and feeds are the window's; replay runs
            # trip_offset steps before the tripped one
            meta["window"] = {
                "start": int(win["start"]), "n_steps": int(win["n_steps"]),
                "feed_per_step": bool(win.get("feed_per_step", False)),
                "trip_offset": int(rec.step - win["start"])}
        with open(os.path.join(bdir, BUNDLE_META), "w") as f:
            json.dump(meta, f, indent=1)
        with open(os.path.join(bdir, BUNDLE_RECORDS), "w") as f:
            json.dump([r.to_dict() for r in self.recorder.records()], f)
        return bdir

    def metrics(self) -> dict:
        """The counters, the last loss scale and the ring's depth."""
        out = dict(self.counters)
        out["loss_scale"] = self.last_scale
        out["ring_depth"] = len(self.recorder.ring)
        return out


# -- module-level management --


def install(config: Optional[GuardianConfig]) -> Optional[Guardian]:
    """Arm (or with None, disarm) the guardian programmatically; this
    overrides ``PADDLE_TPU_GUARDIAN``."""
    global _guardian
    _guardian = Guardian(config) if config is not None else None
    return _guardian


def enable(policy: str = "skip", **kwargs) -> Guardian:
    return install(GuardianConfig(policy=policy, **kwargs))


def disable() -> None:
    install(None)


def current() -> Optional[Guardian]:
    global _guardian
    if _guardian is _UNSET:
        cfg = GuardianConfig.from_env()
        _guardian = Guardian(cfg) if cfg is not None else None
    return _guardian


def metrics() -> dict:
    g = current()
    return g.metrics() if g is not None else {}


def flush() -> None:
    g = current()
    if g is not None:
        g.flush()


# ---------------------------------------------------------------------------
# Replay: re-execute a dumped step and find the first non-finite var
# ---------------------------------------------------------------------------


def replay(bundle_dir: str, place=None, verbose: bool = False) -> dict:
    """Re-execute a replay bundle's recorded step on ``place`` (default:
    the device kind that wrote the bundle; a card bundle needs a card).

    1. The guarded step as the Executor ran it (its plan, its groups, the
       recorded sentinel inputs) from the bundle's state: after the clean
       steps before it for a window's bundle, then the tripped step; the
       loss must reproduce the recorded float32 bits (bitwise on the
       device kind that wrote it).
    2. The tripped step again, op by op from the same state, naming the
       FIRST variable an op made non-finite.

    The step runs under the AMP mode the bundle records.  Returns a report
    dict (the CLI prints it as JSON)."""
    import contextlib

    from . import amp as _amp
    from . import core
    from .framework import Program

    with open(os.path.join(bundle_dir, BUNDLE_META)) as f:
        meta = json.load(f)
    with open(os.path.join(bundle_dir, BUNDLE_PROGRAM), "rb") as f:
        program = Program.parse_from_string(f.read())
    with open(os.path.join(bundle_dir, BUNDLE_FEEDS), "rb") as f:
        feeds = dict(np.load(f))
    with open(os.path.join(bundle_dir, BUNDLE_STATE), "rb") as f:
        state_np = dict(np.load(f))
    if place is None:
        place = core.CUDAPlace(0) if meta.get("device") == "cuda" \
            else core.CPUPlace()
    device = core.torch_device(place)
    amp_dtype, amp_keep = meta.get("amp") or (None, False)
    with (_amp.amp_guard(amp_dtype, keep_activations=amp_keep) if amp_dtype
          else contextlib.nullcontext()):
        report = _replay(meta, program, feeds, state_np, device, verbose)
    report["bundle"] = os.path.abspath(bundle_dir)
    return report


def _replay(meta, program, feeds, state_np, device, verbose) -> dict:
    from .executor import LOD_SUFFIX, BlockPlan, Scope, _run_step, run_op

    user_fetches = meta["fetch_names"]
    extra = meta["extra_fetch_names"]
    spec = GuardSpec(extra[0], extra[1:], meta.get("scale_vars"),
                     meta.get("growth_interval", 1000))
    win = meta.get("window") or {"n_steps": 1, "trip_offset": 0,
                                 "feed_per_step": False}
    trip_offset = int(win["trip_offset"])
    feed_per_step = bool(win["feed_per_step"])
    sent = meta["sentinel"]
    seed_muls = np.asarray(sent.get("seed_mul", 1.0), np.float32).reshape(-1)
    loss_muls = np.asarray(sent.get("loss_mul", 1.0), np.float32).reshape(-1)

    def step_sent(i):
        return {"loss_cap": np.float32(sent.get("loss_cap", np.inf)),
                "seed_mul": seed_muls[min(i, len(seed_muls) - 1)],
                "loss_mul": loss_muls[min(i, len(loss_muls) - 1)]}

    def step_feed(i):
        return {k: torch.from_numpy(np.array(v[i] if feed_per_step else v))
                .to(device) for k, v in feeds.items()}

    lods = {k + LOD_SUFFIX: tuple(tuple(lv) for lv in lod)
            for k, lod in (meta.get("feed_lods") or {}).items()}
    fetches = list(dict.fromkeys(user_fetches + extra))
    plan = BlockPlan(program, list(feeds), fetches)
    scope = Scope()
    for k, v in state_np.items():
        if k != _RNG_KEY:
            scope.set(k, torch.from_numpy(v).to(device))
    generator = None
    if plan.needs_rng:
        generator = torch.Generator(device=device)
        if _RNG_KEY in state_np:
            generator.set_state(torch.from_numpy(state_np[_RNG_KEY]))

    def env_for(i):
        env = {n: scope.get(n) for n in plan.state_in
               if scope.get(n) is not None}
        env.update(step_feed(i))
        env.update(lods)
        env.update(plan.consts)
        return env

    def scale_state():
        return {n: scope.get(n) for n in (spec.scale_vars or ())}

    health = None
    for i in range(trip_offset + 1):
        if i == trip_offset:
            pre_trip = {n: v.clone() for n, v in scope._values.items()}
            gen_state = (generator.get_state() if generator is not None
                         else None)
        env = env_for(i)
        new_state, health = _run_step(plan, env, device, generator, fetches,
                                      spec, step_sent(i), "device",
                                      scale_state())
        for n, v in new_state.items():
            scope.set(n, v)
    replayed = np.float32(float(health["loss"]))
    recorded_bits = meta["loss_bits"]
    replayed_bits = replayed.tobytes().hex()

    # the tripped step again, op by op from the same state
    scope._values = pre_trip
    if generator is not None:
        generator.set_state(gen_state)
    env = env_for(trip_offset)
    sent_i = step_sent(trip_offset)
    seed_mul = seed_multiplier(spec, scale_state(), sent_i, device)
    first_bad, trail = None, []
    for idx, op in enumerate(plan.ops):
        run_op(op, env, device, generator)
        if "__loss_seed__" in op.attrs:
            for n in op.output_arg_names:
                env[n] = env[n] * seed_mul.to(env[n].dtype)
        if verbose:
            trail.append({"op_index": idx, "op_type": op.type})
        if first_bad is not None:
            continue
        for name in op.output_arg_names:
            val = env.get(name)
            if not isinstance(val, torch.Tensor) \
                    or not val.is_floating_point():
                continue
            bad = ~torch.isfinite(val)
            if bool(bad.any()):
                kinds = [k for k, m in (("nan", torch.isnan(val)),
                                        ("inf", torch.isinf(val)))
                         if bool(m.any())]
                first_bad = {"op_index": idx, "op_type": op.type,
                             "var": name, "kind": "+".join(kinds),
                             "bad_count": int(bad.sum()),
                             "size": int(val.numel())}
                break
    report = {
        "step": meta["step"],
        "device": str(device),
        "recorded_loss": meta["loss"],
        "replayed_loss": float(replayed),
        "recorded_loss_bits": recorded_bits,
        "replayed_loss_bits": replayed_bits,
        "bitwise_match": replayed_bits == recorded_bits,
        "first_nonfinite": first_bad,
        "n_ops": len(plan.ops),
        "window": meta.get("window"),
    }
    if verbose:
        report["trail"] = trail
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.fluid.guardian",
        description="Guardian flight-recorder tools.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("replay",
                        help="re-execute a replay bundle and find the first "
                             "non-finite variable")
    rp.add_argument("bundle", help="replay-bundle directory")
    rp.add_argument("--place", choices=("cpu", "cuda"), default=None,
                    help="where to replay (default: the device kind that "
                         "wrote the bundle)")
    rp.add_argument("--verbose", action="store_true",
                    help="include the full op trail in the report")
    args = ap.parse_args(argv)
    from . import core

    place = None if args.place is None else (
        core.CUDAPlace(0) if args.place == "cuda" else core.CPUPlace())
    report = replay(args.bundle, place=place, verbose=args.verbose)
    json.dump(report, sys.stdout, indent=1)
    sys.stdout.write("\n")
    if report["first_nonfinite"] is None and not report["bitwise_match"]:
        return 1  # neither reproduced the bad value nor found one
    return 0


if __name__ == "__main__":
    sys.exit(main())
