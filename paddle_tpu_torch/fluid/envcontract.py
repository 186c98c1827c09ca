"""Env-knob contract (counterpart of ``paddle_tpu/fluid/envcontract.py``):
the ``PADDLE_SERVE_*`` knobs the serving slice reads, with the reference's
names, types and defaults.  Values are read live through :func:`get`."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["EnvKnob", "declare", "get", "REGISTRY"]

_TYPES = ("str", "int", "float", "bool")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


@dataclass(frozen=True)
class EnvKnob:
    name: str
    type: str                      # one of _TYPES
    default: object                # the value `get` returns when unset
    subsystem: str
    help: str

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
        return raw


REGISTRY: Dict[str, EnvKnob] = {}


def declare(name: str, type: str, default, subsystem: str,
            help: str) -> EnvKnob:
    if type not in _TYPES:
        raise ValueError(f"knob type must be one of {_TYPES}, got {type!r}")
    if name in REGISTRY:
        raise ValueError(f"env knob {name} declared twice")
    knob = EnvKnob(name, type, default, subsystem, help)
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
        "Speculative decoding depth k; the port does not carry "
        "speculative decoding yet and refuses k > 0")
