"""Env-knob contract (counterpart of ``paddle_tpu/fluid/envcontract.py``):
the ``PADDLE_SERVE_*`` knobs the serving slice reads, every
``PADDLE_FAULT_*`` knob of ``fluid.fault``, the I/O retry knobs of
``fluid.retry``, the ``PADDLE_TPU_AMP*`` knobs of ``fluid.amp``, the
``PADDLE_TPU_GUARDIAN*`` knobs of ``fluid.guardian``, the trainer's
``PADDLE_TPU_SPD`` and ``PADDLE_TPU_PREFETCH_DEPTH``, the data plane's
``PADDLE_DATA_*`` knobs, and the rank and incident-log knobs they read,
with the reference's names, types and defaults.  Values are read live
through :func:`get`."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["EnvKnob", "declare", "get", "REGISTRY"]

_TYPES = ("str", "int", "float", "bool", "enum", "path", "prefix")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


@dataclass(frozen=True)
class EnvKnob:
    name: str
    type: str                      # one of _TYPES
    default: object                # the value `get` returns when unset
    subsystem: str
    help: str
    choices: Tuple[str, ...] = ()  # for type == "enum"

    def parse(self, raw: Optional[str]):
        """Typed value for a raw env string (None/empty -> default)."""
        if raw is None:
            return self.default
        raw = raw.strip()
        if raw == "":
            return self.default
        if self.type == "int":
            return int(raw)
        if self.type == "float":
            return float(raw)
        if self.type == "bool":
            low = raw.lower()
            if low in _TRUE:
                return True
            if low in _FALSE:
                return False
            return self.default
        if self.type == "enum":
            low = raw.lower()
            return low if low in self.choices else self.default
        return raw  # str / path / prefix


REGISTRY: Dict[str, EnvKnob] = {}


def declare(name: str, type: str, default, subsystem: str, help: str,
            choices: Tuple[str, ...] = ()) -> EnvKnob:
    if type not in _TYPES:
        raise ValueError(f"knob type must be one of {_TYPES}, got {type!r}")
    if name in REGISTRY:
        raise ValueError(f"env knob {name} declared twice")
    knob = EnvKnob(name, type, default, subsystem, help, tuple(choices))
    REGISTRY[name] = knob
    return knob


def get(name: str):
    """Typed live read of a declared knob (KeyError on undeclared names)."""
    knob = REGISTRY.get(name)
    if knob is None:
        raise KeyError(f"env knob {name!r} is not declared in "
                       f"paddle_tpu_torch.fluid.envcontract")
    return knob.parse(os.environ.get(name))


# -- serving (continuous-batching decode path) --
declare("PADDLE_SERVE_DECODE", "bool", True, "serving",
        "Continuous-batching decode master switch (0 makes DecodeEngine "
        "construction refuse)")
declare("PADDLE_SERVE_SLOTS", "int", 8, "serving",
        "Decode slots: concurrent KV-cache-resident streams per engine "
        "(the fixed leading dim of the decode step)")
declare("PADDLE_SERVE_MAX_LEN", "int", 128, "serving",
        "KV-cache capacity per slot (prompt + generated tokens); "
        "admission rejects requests that cannot fit")
declare("PADDLE_SERVE_PREFILL_BUCKETS", "str", "4,8,16", "serving",
        "Comma-separated prompt-length buckets; a prompt pads up to its "
        "enclosing bucket")
declare("PADDLE_SERVE_PAGED", "bool", False, "serving",
        "Paged KV cache (serving/kvpool): per-layer K/V storage becomes a "
        "[num_pages + 1, page_size, d_model] page pool with a host-side "
        "allocator and a per-tick page-table feed; 0 (default) keeps the "
        "dense [max_slots, max_len, d_model] cache")
declare("PADDLE_SERVE_PAGE_SIZE", "int", 4, "serving",
        "KV-cache page length in token positions; must divide max_len "
        "AND every prefill bucket")
declare("PADDLE_SERVE_NUM_PAGES", "int", 0, "serving",
        "Page-pool capacity in pages; 0 = auto: max_slots * max_len / "
        "page_size (dense-equal capacity)")
declare("PADDLE_SERVE_PREFIX_SHARE", "bool", True, "serving",
        "Share read-only full-prompt-page K/V across concurrently resident "
        "slots (refcounted; full-prefix hits skip the prefill dispatch)")
declare("PADDLE_SERVE_SPEC", "int", 0, "serving",
        "Speculative decoding depth k (serving/specdec): each engine tick "
        "runs k cheap draft steps then ONE verify step scoring k+1 "
        "positions per slot; greedy acceptance keeps output bitwise "
        "identical to sequential decode. 0 (default) = the plain one-token "
        "tick, and no draft model is built")
declare("PADDLE_SERVE_SPEC_DRAFT_LAYERS", "int", 1, "serving",
        "Self-draft depth: the draft model reuses the target's first n "
        "decoder layers (+ embeddings/head, shared by name) with its own "
        "dense KV cache; 0 = full-depth self-draft (every draft token "
        "accepted: a throughput ceiling probe, not a speedup)")
declare("PADDLE_SERVE_SPEC_MIN_ACCEPT", "float", 0.3, "serving",
        "Adaptive-fallback floor: a rolling draft-acceptance rate below "
        "this over a full PADDLE_SERVE_SPEC_WINDOW of spec ticks drops the "
        "engine to plain one-token ticks, re-arming after a cooldown of "
        "the same length")
declare("PADDLE_SERVE_SPEC_WINDOW", "int", 32, "serving",
        "Spec-tick window of the rolling acceptance rate and the adaptive "
        "controller (also the fallback cooldown, in plain ticks)")

# -- fault injection (PADDLE_FAULT_* family; fluid/fault.py) --
declare("PADDLE_FAULT_", "prefix", None, "fault",
        "Family prefix: any PADDLE_FAULT_* key is part of the injection "
        "contract parsed by fluid.fault.FaultPlan.from_env")
declare("PADDLE_FAULT_KILL_STEP", "int", None, "fault",
        "Kill this process at training step N")
declare("PADDLE_FAULT_MODE", "str", "exit", "fault",
        "Crash flavor: hard process exit (default) or an in-process "
        "InjectedFault raise (exit|raise)")
declare("PADDLE_FAULT_RANK", "int", None, "fault",
        "Restrict armed faults to one trainer rank")
declare("PADDLE_FAULT_CKPT_CRASH", "str", None, "fault",
        "Crash inside checkpoint save (before|after the _SUCCESS commit)")
declare("PADDLE_FAULT_IO_DELAY_MS", "float", 0.0, "fault",
        "Inject IO delay into checkpoint writes and prefetch staging (ms)")
declare("PADDLE_FAULT_NAN_VAR", "str", None, "fault",
        "Corrupt this state var with NaNs after a step")
declare("PADDLE_FAULT_NAN_STEP", "int", 0, "fault",
        "Step at which the NaN corruption fires")
declare("PADDLE_FAULT_GRAD_INF_STEP", "int", None, "fault",
        "Poison the backward seed with Inf at step N (on the device)")
declare("PADDLE_FAULT_GRAD_INF_VALUE", "float", float("inf"), "fault",
        "Poison value for the grad-Inf injection")
declare("PADDLE_FAULT_LOSS_SPIKE_STEP", "int", None, "fault",
        "Multiply the observed loss at step N (spike injection)")
declare("PADDLE_FAULT_LOSS_SPIKE_FACTOR", "float", 1e4, "fault",
        "Spike multiplication factor")
declare("PADDLE_FAULT_BARRIER_STALL", "float", 0.0, "fault",
        "Stall this rank's barrier entry (seconds)")
declare("PADDLE_FAULT_SERVE_DELAY_MS", "float", 0.0, "fault",
        "Per-request serving delay injection (ms)")
declare("PADDLE_FAULT_SERVE_FAIL_EVERY", "int", 0, "fault",
        "Fail every Nth serving request with InjectedFault")
declare("PADDLE_FAULT_DECODE_STALL_MS", "float", 0.0, "fault",
        "Stall every continuous-batching decode tick (ms): deterministic "
        "inter-token-latency inflation")
declare("PADDLE_FAULT_CKPT_POISON_SERIAL", "int", None, "fault",
        "NaN-poison checkpoint serial n at save time, committed WITH a "
        "valid _SUCCESS")
declare("PADDLE_FAULT_CACHE_CORRUPT", "bool", False, "fault",
        "Deterministically corrupt the next compile-cache read")
declare("PADDLE_FAULT_DATA_STALL_MS", "float", 0.0, "fault",
        "Stall the input pipeline per pulled sample (ms)")
declare("PADDLE_FAULT_DATA_STALL_AT", "int", None, "fault",
        "Fire the data stall once, at this source sample cursor")
declare("PADDLE_FAULT_SHARD_CORRUPT", "bool", False, "fault",
        "Truncate the next data_state blob write (one-shot)")
declare("PADDLE_FAULT_MEM_PRESSURE", "float", 0.0, "fault",
        "Synthesize a memory leak: after PADDLE_FAULT_MEM_PRESSURE_AT "
        "ledger observations, add this many MB of phantom live bytes, "
        "doubling per observation")
declare("PADDLE_FAULT_MEM_PRESSURE_AT", "int", 8, "fault",
        "Ledger observation count at which the synthetic leak starts")
declare("PADDLE_FAULT_STRAGGLER_RANK", "int", None, "fault",
        "Deterministic straggler oracle: slow down exactly this trainer "
        "rank (ignores PADDLE_FAULT_RANK)")
declare("PADDLE_FAULT_STRAGGLER_MS", "float", 0.0, "fault",
        "Per-step delay (ms) injected into the straggler rank's step "
        "boundary")
declare("PADDLE_FAULT_HOST_LOSS_RANK", "int", None, "fault",
        "Permanent host loss: this rank exits hard at the armed step "
        "boundary and drops a host_lost marker for the supervisor census")
declare("PADDLE_FAULT_HOST_LOSS_AT_STEP", "int", 0, "fault",
        "Training step at which the host-loss fault fires")
declare("PADDLE_FAULT_REPLICA_KILL_AFTER", "int", None, "fault",
        "Serving-fleet replica death: kill the replica that served the "
        "n-th fleet request (one-shot)")
declare("PADDLE_FAULT_IO_ERROR_RATE", "float", 0.0, "fault",
        "Transient-storage oracle: fraction of (path, op) keys whose "
        "FIRST read/write attempt raises OSError (seeded per-path hash; "
        "the retry always succeeds)")
declare("PADDLE_FAULT_IO_ERROR_SEED", "int", 0, "fault",
        "Seed for the transient-I/O oracle's per-path failure hash")
declare("PADDLE_FAULT_KV_PAGE_LEAK", "int", None, "fault",
        "Paged-KV leak oracle: the page-pool allocator SKIPS the next n "
        "frees (one-shot), so pages_free never returns to its initial "
        "level")
declare("PADDLE_FAULT_SPEC_DRAFT_POISON", "int", None, "fault",
        "Speculative-draft poison: from engine tick n on, every drafted "
        "token is replaced with deterministic garbage, so acceptance "
        "collapses and the spec controller must fall back, while the "
        "emitted streams stay bitwise correct")

# -- the rank and the incident log the fault and guardian hooks read --
declare("PADDLE_TRAINER_ID", "int", 0, "parallel",
        "This process's trainer rank (the fault rank filter's source)")
declare("PADDLE_TPU_MESH", "str", None, "parallel",
        "Named mesh spec, e.g. dp4,tp2 (axis order = spec order)")
declare("PADDLE_TRAINERS", "int", 1, "parallel",
        "Process count of the torch.distributed group")
declare("PADDLE_COORDINATOR_ADDR", "str", None, "parallel",
        "host:port of the group's tcp rendezvous (rank 0)")
declare("PADDLE_PSERVER_EPS", "str", None, "parallel",
        "Legacy pserver endpoint list (transpiler compatibility)")
declare("PADDLE_LOCAL_DEVICE_IDS", "str", None, "parallel",
        "Comma-separated local device ids visible to this process")
declare("PADDLE_ELASTIC_INCIDENTS", "path", None, "elastic",
        "Incident log (jsonl) a guardian trip appends one line to")

# -- guardian (fluid/guardian.py) --
declare("PADDLE_TPU_GUARDIAN", "str", None, "guardian",
        "Arm the numerics guardian (skip|halt|dump_and_halt, or 1=skip)")
declare("PADDLE_TPU_GUARDIAN_SPIKE", "float", 0.0, "guardian",
        "Loss-spike rejection factor over the window median (0 = off)")
declare("PADDLE_TPU_GUARDIAN_WINDOW", "int", 32, "guardian",
        "Spike-median window length (steps)")
declare("PADDLE_TPU_GUARDIAN_RING", "int", 128, "guardian",
        "Flight-recorder ring size (steps)")
declare("PADDLE_TPU_GUARDIAN_DIR", "path", None, "guardian",
        "Flight-recorder replay-bundle directory")

# -- transient-I/O retry (fluid.retry, wraps checkpoint read/write) --
declare("PADDLE_IO_RETRIES", "int", 3, "io",
        "Bounded attempts for transient OSErrors on checkpoint I/O (1 = no "
        "retry; corruption is never retried)")
declare("PADDLE_IO_RETRY_BASE_S", "float", 0.05, "io",
        "Base backoff delay between transient-I/O retries (seconds, "
        "doubling per attempt, capped at 2 s)")

# -- trainer --
declare("PADDLE_TPU_SPD", "int", 0, "trainer",
        "Steps per dispatch: K>1 runs the trainer loop as K-step "
        "windows (Executor.run_steps)")
declare("PADDLE_TPU_PREFETCH_DEPTH", "int", 2, "trainer",
        "Device prefetch depth for windowed training (0 = synchronous)")

# -- AMP (read by fluid.amp at import and by amp.enable) --
declare("PADDLE_TPU_AMP", "enum", None, "amp",
        "Enable mixed precision at import", choices=("bfloat16", "float16"))
declare("PADDLE_TPU_AMP_KEEP", "bool", False, "amp",
        "Keep activations in the low compute dtype (pure-low regime)")
declare("PADDLE_TPU_AMP_INIT_SCALE", "float", 2.0 ** 15, "amp",
        "Initial dynamic fp16 loss scale")
declare("PADDLE_TPU_AMP_SCALE_INTERVAL", "int", 1000, "amp",
        "Overflow-free steps between loss-scale growth events")

# -- data plane (paddle_tpu_torch.data) --
declare("PADDLE_DATA_CKPT", "bool", True, "data",
        "Commit/restore checkpointable-reader state with checkpoints "
        "(0 falls back to sample-skip replay)")
declare("PADDLE_DATA_STALL_EVENT_MS", "float", 100.0, "data",
        "Input waits above this count as a data stall "
        "(data.stall_events)")
