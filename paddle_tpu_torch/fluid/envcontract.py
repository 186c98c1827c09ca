"""Env-knob contract (counterpart of ``paddle_tpu/fluid/envcontract.py``):
the ``PADDLE_SERVE_*`` knobs the serving slice reads, the fault knobs of
``fluid.fault``, the I/O retry knobs of ``fluid.retry``, the
``PADDLE_TPU_AMP*`` knobs of ``fluid.amp`` and the prefetcher's
``PADDLE_TPU_PREFETCH_DEPTH``, with the reference's names, types and
defaults.  Values are read live through :func:`get`."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

__all__ = ["EnvKnob", "declare", "get", "REGISTRY"]

_TYPES = ("str", "int", "float", "bool", "enum")

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
        return raw


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

# -- fault injection (fluid/fault.py) --
declare("PADDLE_FAULT_SPEC_DRAFT_POISON", "int", None, "fault",
        "Speculative-draft poison: from engine tick n on, every drafted "
        "token is replaced with deterministic garbage, so acceptance "
        "collapses and the spec controller must fall back, while the "
        "emitted streams stay bitwise correct")
declare("PADDLE_FAULT_IO_DELAY_MS", "float", 0.0, "fault",
        "Inject IO delay into checkpoint read/write paths (ms)")
declare("PADDLE_FAULT_IO_ERROR_RATE", "float", 0.0, "fault",
        "Transient-storage oracle: fraction of (path, op) keys whose "
        "FIRST read/write attempt raises OSError (seeded per-path hash; "
        "the retry always succeeds)")
declare("PADDLE_FAULT_IO_ERROR_SEED", "int", 0, "fault",
        "Seed for the transient-I/O oracle's per-path failure hash")

# -- transient-I/O retry (fluid.retry, wraps checkpoint read/write) --
declare("PADDLE_IO_RETRIES", "int", 3, "io",
        "Bounded attempts for transient OSErrors on checkpoint I/O (1 = no "
        "retry; corruption is never retried)")
declare("PADDLE_IO_RETRY_BASE_S", "float", 0.05, "io",
        "Base backoff delay between transient-I/O retries (seconds, "
        "doubling per attempt, capped at 2 s)")

# -- trainer --
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
