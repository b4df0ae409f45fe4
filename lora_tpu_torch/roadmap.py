"""Options of lora_tpu that the port does not carry yet, by ROADMAP.md item.

Each raises NotImplementedError naming its item; none falls back in
silence to another route."""

from __future__ import annotations

ITEMS = {
    13: "bf16 and interpret routes",
}


def not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md item {item}: {ITEMS[item]})")
