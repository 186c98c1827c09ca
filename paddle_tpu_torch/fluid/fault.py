"""Deterministic fault injection (counterpart of
``paddle_tpu/fluid/fault.py``): one place that reproduces, on demand and
at a chosen step, the failures a training or serving process meets —
killed workers, checkpoints cut mid-write, slow or failing storage, silent
NaNs, overflowing gradients, loss spikes, stalled input, leaked KV pages —
so the recovery paths (``fluid.trainer``, ``fluid.guardian``, ``data``,
the serving engine) are driven by fast tests.

A plan is armed programmatically (``install(FaultPlan(...))``) or from the
environment, read through ``fluid.envcontract`` the first time
:func:`active` is asked.  ``FaultPlan.from_env`` reads every
``PADDLE_FAULT_*`` knob of the reference, under the same names, types and
defaults:

    PADDLE_FAULT_KILL_STEP=N      die at the step-N boundary (os._exit 137,
                                  a SIGKILL stand-in: no atexit, no flush)
    PADDLE_FAULT_RANK=r           restrict the armed faults to rank r
                                  (the rank is PADDLE_TRAINER_ID)
    PADDLE_FAULT_MODE=exit|raise  a hard exit (default) or an
                                  InjectedFault raise (in-process tests)
    PADDLE_FAULT_CKPT_CRASH=before|after
                                  crash inside a checkpoint save, just
                                  before / after its _SUCCESS marker
    PADDLE_FAULT_CKPT_POISON_SERIAL=n
                                  rewrite every float file of checkpoint
                                  serial n as NaN before its _SUCCESS: a
                                  committed, valid-looking bad checkpoint
    PADDLE_FAULT_IO_DELAY_MS=t    sleep t ms in every checkpoint write and
                                  every staged prefetch window
    PADDLE_FAULT_IO_ERROR_RATE=f  the first attempt at a seeded fraction f
                                  of (path, op) keys raises OSError;
    PADDLE_FAULT_IO_ERROR_SEED=s  ``fluid.retry`` must recover
    PADDLE_FAULT_NAN_VAR=name     overwrite var ``name`` with NaN once,
    PADDLE_FAULT_NAN_STEP=N       after step N (default 0)
    PADDLE_FAULT_GRAD_INF_STEP=N  multiply step N's backward seed by
    PADDLE_FAULT_GRAD_INF_VALUE=v v (default inf) on the device: every
                                  gradient goes Inf through the real grad
                                  ops (the guardian's and the fp16 loss
                                  scaler's oracle)
    PADDLE_FAULT_LOSS_SPIKE_STEP=N
                                  multiply the observed loss of step N by
    PADDLE_FAULT_LOSS_SPIKE_FACTOR=f
                                  f (default 1e4): the spike oracle
    PADDLE_FAULT_DECODE_STALL_MS=t
                                  stall every continuous-batching decode
                                  tick t ms
    PADDLE_FAULT_KV_PAGE_LEAK=n   the KV page pool skips its next n page
                                  frees: ``pages_leaked`` counts them
    PADDLE_FAULT_SPEC_DRAFT_POISON=n
                                  from engine tick n on, every drafted
                                  token is garbage: acceptance collapses,
                                  the streams stay bitwise correct
    PADDLE_FAULT_DATA_STALL_MS=t  stall the input pipeline t ms a pulled
    PADDLE_FAULT_DATA_STALL_AT=N  sample, or once, at source cursor N
    PADDLE_FAULT_SHARD_CORRUPT=1  truncate the next data_state blob write
                                  (one-shot): a resume must fall back
    PADDLE_FAULT_STRAGGLER_RANK=r rank r sleeps
    PADDLE_FAULT_STRAGGLER_MS=t   t ms a training step at the boundary

The plan also carries the reference's serving, fleet, cache, memory,
barrier and host-loss knobs (``PADDLE_FAULT_SERVE_DELAY_MS``,
``_SERVE_FAIL_EVERY``, ``_REPLICA_KILL_AFTER``, ``_CACHE_CORRUPT``,
``_MEM_PRESSURE``, ``_MEM_PRESSURE_AT``, ``_BARRIER_STALL``,
``_HOST_LOSS_RANK``, ``_HOST_LOSS_AT_STEP``), so ``from_env`` reads the
whole contract; their hooks (``serving_request``, ``replica_kill``,
``cache_corrupt``, ``mem_pressure_bytes``, ``barrier_stall``, host loss)
come with the batch serving engine and the fleet, the compile cache and
memory ledger, and the multi-process paths that consult them
(``ROADMAP.md`` queue 1 items 9-12).

Hook points (each costs one attribute read when nothing is armed):
``Executor.run`` / ``run_steps`` call :func:`on_step` / :func:`advance`
and :func:`straggler_delay` at a training step boundary and
:func:`corrupt_state` on the step's new state, and take
:func:`sentinel_injection` / :func:`sentinel_injection_window` into the
guarded step; ``trainer.save_checkpoint`` calls :func:`ckpt_poison` and
:func:`ckpt_crash_point` around its _SUCCESS write; ``fluid.io`` calls
:func:`io_delay` and :func:`io_error` around every checkpoint file; the
prefetcher calls :func:`io_delay` per staged window; ``data`` calls
:func:`data_stall` per pulled sample and :func:`shard_corrupt` per blob
write; the decode engine calls :func:`decode_stall` per tick, the page
pool :func:`kv_page_leak` per free, the speculative decoder
:func:`spec_draft_poison` per spec tick.

Determinism: a fault keyed to step N fires at step N of the caller's step
index when one is given (``on_step(step)``: a resumed worker that passes
its global step never fires a kill it already survived), else of a
per-process counter.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from typing import Optional

__all__ = [
    "FaultPlan", "InjectedFault", "install", "clear", "active",
    "on_step", "advance", "current_step", "corrupt_state",
    "sentinel_injection", "sentinel_injection_window", "ckpt_crash_point",
    "ckpt_poison", "io_delay", "io_error", "decode_stall", "kv_page_leak",
    "spec_draft_poison", "data_stall", "shard_corrupt", "straggler_delay",
    "KILL_EXIT_CODE",
]

#: exit code of an injected kill: 128 + 9, what a real SIGKILL reports
KILL_EXIT_CODE = 137

# FaultPlan field -> its env knob, in the reference's order
_ENV_FIELDS = {
    "kill_step": "PADDLE_FAULT_KILL_STEP",
    "ckpt_crash": "PADDLE_FAULT_CKPT_CRASH",
    "ckpt_poison_serial": "PADDLE_FAULT_CKPT_POISON_SERIAL",
    "io_delay_ms": "PADDLE_FAULT_IO_DELAY_MS",
    "nan_var": "PADDLE_FAULT_NAN_VAR",
    "nan_step": "PADDLE_FAULT_NAN_STEP",
    "grad_inf_step": "PADDLE_FAULT_GRAD_INF_STEP",
    "grad_inf_value": "PADDLE_FAULT_GRAD_INF_VALUE",
    "loss_spike_step": "PADDLE_FAULT_LOSS_SPIKE_STEP",
    "loss_spike_factor": "PADDLE_FAULT_LOSS_SPIKE_FACTOR",
    "barrier_stall_s": "PADDLE_FAULT_BARRIER_STALL",
    "serve_delay_ms": "PADDLE_FAULT_SERVE_DELAY_MS",
    "serve_fail_every": "PADDLE_FAULT_SERVE_FAIL_EVERY",
    "decode_stall_ms": "PADDLE_FAULT_DECODE_STALL_MS",
    "kv_page_leak": "PADDLE_FAULT_KV_PAGE_LEAK",
    "spec_draft_poison": "PADDLE_FAULT_SPEC_DRAFT_POISON",
    "replica_kill_after": "PADDLE_FAULT_REPLICA_KILL_AFTER",
    "cache_corrupt": "PADDLE_FAULT_CACHE_CORRUPT",
    "data_stall_ms": "PADDLE_FAULT_DATA_STALL_MS",
    "data_stall_at": "PADDLE_FAULT_DATA_STALL_AT",
    "shard_corrupt": "PADDLE_FAULT_SHARD_CORRUPT",
    "mem_pressure_mb": "PADDLE_FAULT_MEM_PRESSURE",
    "mem_pressure_at": "PADDLE_FAULT_MEM_PRESSURE_AT",
    "straggler_rank": "PADDLE_FAULT_STRAGGLER_RANK",
    "straggler_ms": "PADDLE_FAULT_STRAGGLER_MS",
    "host_loss_rank": "PADDLE_FAULT_HOST_LOSS_RANK",
    "host_loss_at_step": "PADDLE_FAULT_HOST_LOSS_AT_STEP",
    "io_error_rate": "PADDLE_FAULT_IO_ERROR_RATE",
    "io_error_seed": "PADDLE_FAULT_IO_ERROR_SEED",
    "rank": "PADDLE_FAULT_RANK",
    "mode": "PADDLE_FAULT_MODE",
}


def _log(msg: str) -> None:
    sys.stderr.write(f"fault: {msg}\n")
    sys.stderr.flush()


def _trainer_rank() -> int:
    from . import envcontract

    return int(envcontract.get("PADDLE_TRAINER_ID"))


def _opt_int(v):
    return None if v is None else int(v)


class InjectedFault(BaseException):
    """The raise-mode crash.  A BaseException on purpose: recovery code
    that catches ``Exception`` must treat an injected crash like a real
    process death, not swallow it."""


class FaultPlan:
    """One armed fault scenario; every field optional, ``None`` (or 0)
    disarms its fault."""

    def __init__(self, kill_step: Optional[int] = None,
                 ckpt_crash: Optional[str] = None,
                 ckpt_poison_serial: Optional[int] = None,
                 io_delay_ms: float = 0.0,
                 nan_var: Optional[str] = None, nan_step: int = 0,
                 grad_inf_step: Optional[int] = None,
                 grad_inf_value: float = float("inf"),
                 loss_spike_step: Optional[int] = None,
                 loss_spike_factor: float = 1e4,
                 barrier_stall_s: float = 0.0,
                 serve_delay_ms: float = 0.0, serve_fail_every: int = 0,
                 decode_stall_ms: float = 0.0,
                 kv_page_leak: Optional[int] = None,
                 spec_draft_poison: Optional[int] = None,
                 replica_kill_after: Optional[int] = None,
                 cache_corrupt: bool = False,
                 data_stall_ms: float = 0.0,
                 data_stall_at: Optional[int] = None,
                 shard_corrupt: bool = False,
                 mem_pressure_mb: float = 0.0,
                 mem_pressure_at: int = 8,
                 straggler_rank: Optional[int] = None,
                 straggler_ms: float = 0.0,
                 host_loss_rank: Optional[int] = None,
                 host_loss_at_step: int = 0,
                 io_error_rate: float = 0.0, io_error_seed: int = 0,
                 rank: Optional[int] = None, mode: str = "exit"):
        if ckpt_crash not in (None, "before", "after"):
            raise ValueError(
                f"ckpt_crash must be 'before' or 'after' (the _SUCCESS "
                f"marker), got {ckpt_crash!r}")
        if mode not in ("exit", "raise"):
            raise ValueError(f"mode must be 'exit' or 'raise', got {mode!r}")
        self.kill_step = _opt_int(kill_step)
        self.ckpt_crash = ckpt_crash
        self.ckpt_poison_serial = _opt_int(ckpt_poison_serial)
        self.io_delay_ms = float(io_delay_ms)
        self.nan_var = nan_var
        self.nan_step = int(nan_step)
        self.grad_inf_step = _opt_int(grad_inf_step)
        self.grad_inf_value = float(grad_inf_value)
        self.loss_spike_step = _opt_int(loss_spike_step)
        self.loss_spike_factor = float(loss_spike_factor)
        self.barrier_stall_s = float(barrier_stall_s)
        self.serve_delay_ms = float(serve_delay_ms)
        self.serve_fail_every = int(serve_fail_every)
        self.decode_stall_ms = float(decode_stall_ms)
        self.kv_page_leak = _opt_int(kv_page_leak)
        self.spec_draft_poison = _opt_int(spec_draft_poison)
        self.replica_kill_after = _opt_int(replica_kill_after)
        self.cache_corrupt = bool(cache_corrupt)
        self.data_stall_ms = float(data_stall_ms)
        self.data_stall_at = _opt_int(data_stall_at)
        self.shard_corrupt = bool(shard_corrupt)
        self.mem_pressure_mb = float(mem_pressure_mb)
        self.mem_pressure_at = int(mem_pressure_at)
        self.straggler_rank = _opt_int(straggler_rank)
        self.straggler_ms = float(straggler_ms)
        self.host_loss_rank = _opt_int(host_loss_rank)
        self.host_loss_at_step = int(host_loss_at_step)
        self.io_error_rate = float(io_error_rate)
        self.io_error_seed = int(io_error_seed)
        self.rank = _opt_int(rank)
        self.mode = mode
        # one-shot disarm state
        self._io_error_attempts: dict = {}
        self._nan_fired = False
        self._data_stall_fired = False
        self._shard_corrupt_fired = False
        self._kv_leaks_left = self.kv_page_leak or 0

    @classmethod
    def from_env(cls, env=None) -> Optional["FaultPlan"]:
        """The ``PADDLE_FAULT_*`` knobs of ``env`` (default: the process
        environment) as a plan, each through its ``fluid.envcontract``
        declaration; None when no such knob is set."""
        env = os.environ if env is None else env
        if not any(k.startswith("PADDLE_FAULT_") and (v or "").strip()
                   for k, v in env.items()):
            return None
        from . import envcontract as _ec

        return cls(**{field: _ec.REGISTRY[name].parse(env.get(name))
                      for field, name in _ENV_FIELDS.items()})

    def _applies_to_this_rank(self) -> bool:
        return self.rank is None or self.rank == _trainer_rank()

    def _crash(self, what: str):
        if self.mode == "raise":
            raise InjectedFault(what)
        _log(f"injected crash ({what}): exiting {KILL_EXIT_CODE}")
        os._exit(KILL_EXIT_CODE)


# the armed plan (None = nothing armed; _UNSET = the environment not read
# yet, so a process that sets PADDLE_FAULT_* before first use is honoured)
# and the step counter
_UNSET = object()
_plan = _UNSET
_step = 0


def install(plan: Optional[FaultPlan]) -> None:
    """Arm a plan programmatically (overrides the environment); the step
    counter restarts at 0."""
    global _plan, _step
    _plan = plan
    _step = 0


def clear() -> None:
    """Disarm everything, including a plan read from the environment."""
    install(None)


def active() -> Optional[FaultPlan]:
    global _plan
    if _plan is _UNSET:
        _plan = FaultPlan.from_env()
    return _plan


def current_step() -> int:
    return _step


def on_step(step: Optional[int] = None) -> int:
    """The training-step boundary, before the step runs.  ``step`` pins
    the index (a resume-aware caller); default a per-process counter.
    Fires kill-at-step.  Returns the step that runs now."""
    global _step
    if step is not None:
        _step = int(step)
    plan = active()
    if plan is not None and plan.kill_step is not None \
            and _step == plan.kill_step and plan._applies_to_this_rank():
        plan._crash(f"kill at step {_step}")
    fired = _step
    _step += 1
    return fired


def advance(n: int) -> None:
    """The boundary of an ``n``-step window (``run_steps``): a kill armed
    anywhere inside the window fires before the window runs."""
    global _step
    plan = active()
    if plan is not None and plan.kill_step is not None \
            and _step <= plan.kill_step < _step + n \
            and plan._applies_to_this_rank():
        plan._crash(f"kill inside step window [{_step}, {_step + n})")
    _step += n


def corrupt_state(named_vals: dict) -> dict:
    """NaN-poison the armed var once its step has passed (one-shot).
    Called with a step's new state; returns it, with the var replaced by a
    NaN tensor of its shape on its device, so the NaN flows on into the
    scope like a real blow-up."""
    plan = active()
    if plan is None or plan.nan_var is None or plan._nan_fired \
            or _step <= plan.nan_step or not plan._applies_to_this_rank():
        return named_vals
    if plan.nan_var in named_vals:
        import torch

        val = named_vals[plan.nan_var]
        dtype = val.dtype if val.is_floating_point() else torch.float32
        named_vals = dict(named_vals)
        named_vals[plan.nan_var] = torch.full(
            tuple(val.shape), float("nan"), dtype=dtype, device=val.device)
        plan._nan_fired = True
    return named_vals


def sentinel_injection(step: int):
    """The guardian's per-step multipliers ``(seed_mul, loss_mul)``, both
    1.0 unless a grad-Inf or a loss spike is armed at ``step``.  Keyed on
    step equality: a run that executes the step again fires again."""
    plan = active()
    if plan is None or not plan._applies_to_this_rank():
        return 1.0, 1.0
    seed_mul = plan.grad_inf_value if plan.grad_inf_step == step else 1.0
    loss_mul = plan.loss_spike_factor if plan.loss_spike_step == step \
        else 1.0
    return seed_mul, loss_mul


def sentinel_injection_window(start: int, n_steps: int):
    """:func:`sentinel_injection` over steps ``[start, start + n_steps)``:
    float32 arrays ``(seed_mul, loss_mul)`` of shape ``(n_steps,)``; the
    window's step ``i`` takes entry ``i``."""
    import numpy as np

    seed = np.ones(n_steps, np.float32)
    loss = np.ones(n_steps, np.float32)
    plan = active()
    if plan is not None and plan._applies_to_this_rank():
        if plan.grad_inf_step is not None \
                and start <= plan.grad_inf_step < start + n_steps:
            seed[plan.grad_inf_step - start] = plan.grad_inf_value
        if plan.loss_spike_step is not None \
                and start <= plan.loss_spike_step < start + n_steps:
            loss[plan.loss_spike_step - start] = plan.loss_spike_factor
    return seed, loss


def ckpt_crash_point(where: str) -> None:
    """The checkpoint-save crash hook; ``where`` is 'before' or 'after'
    the _SUCCESS marker write."""
    plan = active()
    if plan is not None and plan.ckpt_crash == where \
            and plan._applies_to_this_rank():
        plan._crash(f"checkpoint crash {where} _SUCCESS")


def ckpt_poison(serial: int, dirname: str) -> bool:
    """When ``ckpt_poison_serial`` is ``serial``, rewrite every float
    ``.npy`` payload under ``dirname`` as all-NaN in place, before the
    caller commits its _SUCCESS: the serial ends up committed and
    structurally valid.  Integer and unreadable files stay.  True when it
    fired."""
    plan = active()
    if plan is None or plan.ckpt_poison_serial is None \
            or plan.ckpt_poison_serial != int(serial) \
            or not plan._applies_to_this_rank():
        return False
    import numpy as np

    fired = False
    for root, _dirs, files in os.walk(dirname):
        for fname in files:
            path = os.path.join(root, fname)
            try:
                arr = np.load(path, allow_pickle=False)
            except Exception:
                continue  # markers, manifests, other payloads
            if not np.issubdtype(arr.dtype, np.floating):
                continue
            with open(path, "wb") as f:
                np.save(f, np.full_like(arr, np.nan), allow_pickle=False)
            fired = True
    if fired:
        _log(f"NaN-poisoned checkpoint serial {serial} at {dirname}")
    return fired


def io_delay() -> None:
    """Slow-storage simulation: sleep inside checkpoint writes and staged
    prefetch windows."""
    plan = active()
    if plan is not None and plan.io_delay_ms > 0 \
            and plan._applies_to_this_rank():
        time.sleep(plan.io_delay_ms / 1000.0)


def _io_error_key(path: str) -> str:
    """A file's identity across runs: the path's last two components (the
    enclosing temporary directory differs per run, the tail does not)."""
    parts = [p for p in os.path.normpath(path).split(os.sep) if p]
    return "/".join(parts[-2:])


def io_error(path: str, op: str) -> None:
    """Transient-I/O oracle, consulted right before each raw read or write
    of a checkpoint file: a seeded hash of ``(seed, path tail, op)`` picks
    the fraction ``io_error_rate`` of keys that fail; a picked key's FIRST
    attempt raises OSError and every later attempt succeeds, so bounded
    retry (``fluid.retry.retry_io``) always recovers.  The reference's
    hash: one seed fails the same files in both packages."""
    plan = active()
    if plan is None or plan.io_error_rate <= 0 \
            or not plan._applies_to_this_rank():
        return
    key = (_io_error_key(path), str(op))
    digest = hashlib.sha1(
        f"{plan.io_error_seed}|{key[0]}|{key[1]}".encode()).hexdigest()
    if int(digest[:8], 16) / float(0xFFFFFFFF) >= plan.io_error_rate:
        return
    attempts = plan._io_error_attempts.get(key, 0)
    plan._io_error_attempts[key] = attempts + 1
    if attempts == 0:
        raise OSError(
            f"injected transient I/O error ({key[1]} {key[0]}, "
            f"attempt 1 — retry succeeds)")


def decode_stall(n_ticks: int = 1) -> None:
    """The decode engine's per-tick stall: every in-flight stream's
    inter-token latency grows by the same amount."""
    plan = active()
    if plan is None or plan.decode_stall_ms <= 0 \
            or not plan._applies_to_this_rank():
        return
    time.sleep(plan.decode_stall_ms * max(1, int(n_ticks)) / 1000.0)


def kv_page_leak() -> bool:
    """The page pool's leak oracle, asked once per page free: True for the
    first ``kv_page_leak`` calls (the pool then skips that free), then
    False for good."""
    plan = active()
    if plan is None or plan._kv_leaks_left <= 0 \
            or not plan._applies_to_this_rank():
        return False
    plan._kv_leaks_left -= 1
    return True


def spec_draft_poison() -> Optional[int]:
    """The engine tick from which the speculative draft is poisoned, or
    None when disarmed (``serving/specdec`` asks once a spec tick)."""
    plan = active()
    if plan is None or plan.spec_draft_poison is None \
            or not plan._applies_to_this_rank():
        return None
    return plan.spec_draft_poison


def data_stall(index: int) -> None:
    """The input pipeline's stall, asked once per pulled sample (``index``
    is the source's cursor in its epoch): every sample, or with
    ``data_stall_at`` once, at that cursor."""
    plan = active()
    if plan is None or plan.data_stall_ms <= 0 \
            or not plan._applies_to_this_rank():
        return
    if plan.data_stall_at is None:
        time.sleep(plan.data_stall_ms / 1000.0)
    elif not plan._data_stall_fired and int(index) == plan.data_stall_at:
        plan._data_stall_fired = True
        time.sleep(plan.data_stall_ms / 1000.0)


def shard_corrupt() -> bool:
    """True exactly once when armed: the next ``data_state`` blob write is
    truncated, so a resume must find the cursor corrupt and fall back to
    the previous complete serial."""
    plan = active()
    if plan is None or not plan.shard_corrupt or plan._shard_corrupt_fired \
            or not plan._applies_to_this_rank():
        return False
    plan._shard_corrupt_fired = True
    return True


def straggler_delay(n_steps: int = 1) -> None:
    """The straggler: the armed rank sleeps ``straggler_ms`` a step at the
    training step boundary (a window sleeps once for its steps).  Keyed
    on ``straggler_rank`` alone, not on ``PADDLE_FAULT_RANK``."""
    plan = active()
    if plan is None or plan.straggler_ms <= 0:
        return
    if plan.straggler_rank is not None \
            and plan.straggler_rank != _trainer_rank():
        return
    time.sleep(plan.straggler_ms * max(1, int(n_steps)) / 1000.0)
