"""Device idle time under the detector's and the long-term memory's
program spans (``detector.*``, ``longterm.*``), by
``_program_spans.idle_by_layer``: each idle instant of the traced window
counted once, for the innermost program span open on the host then.  A
program that keeps no such spans gives None: the readers then report
nothing."""

from __future__ import annotations

from typing import Dict, Optional

from navbench.metrics import _program_spans as PS

# innermost span name (prefix) -> the layer its idle time is put against
LAYERS = (("detector.", "detector"), ("longterm.", "longterm"))


def idle_by_layer(out) -> Optional[Dict[str, float]]:
    """Seconds of the traced window in which the device was idle, by the
    layer (``LAYERS``) of the innermost program span open then; None
    where the program recorded no span of these layers."""
    spans = PS.mapped(out)
    if not spans or not any(n.startswith(tuple(p for p, _ in LAYERS))
                            for _, _, n, _ in spans):
        return None
    # ``idle_by_layer`` reads its module's map; lend it this one
    build_layers, PS.IDLE_LAYERS = PS.IDLE_LAYERS, LAYERS
    try:
        return PS.idle_by_layer(out)
    finally:
        PS.IDLE_LAYERS = build_layers


def idle_ms(out, layer: str) -> Optional[float]:
    """ms a traced flush the device was idle under ``layer``'s spans."""
    if out.trace is None or not out.traced_items:
        return None
    by = idle_by_layer(out)
    return None if by is None else 1e3 * by.get(layer, 0.0) / out.traced_items
