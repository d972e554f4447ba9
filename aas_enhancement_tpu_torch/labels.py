"""Character vocabulary for CTC (copy of ``aas_enhancement_tpu/labels.py``).

Index 0 is the CTC blank ('_'); the default is the standard English charset,
and a custom list loads from JSON.
"""

from __future__ import annotations

import json

# Index 0 is the CTC blank ('_').
LABELS: str = "_'ABCDEFGHIJKLMNOPQRSTUVWXYZ "

BLANK_ID: int = 0


def label_maps(labels: str = LABELS) -> tuple[dict[str, int], dict[int, str]]:
    char_to_id = {c: i for i, c in enumerate(labels)}
    id_to_char = {i: c for i, c in enumerate(labels)}
    return char_to_id, id_to_char


def encode(text: str, labels: str = LABELS) -> list[int]:
    """Transcript string -> label ids (unknown chars dropped, case-folded)."""
    char_to_id, _ = label_maps(labels)
    return [char_to_id[c] for c in text.upper() if c in char_to_id]


def decode_ids(ids, labels: str = LABELS) -> str:
    """Label ids -> string (blanks dropped; no CTC collapse — see decode.greedy)."""
    _, id_to_char = label_maps(labels)
    return "".join(id_to_char[int(i)] for i in ids if int(i) != BLANK_ID)


def load_labels(path: str) -> str:
    with open(path) as f:
        data = json.load(f)
    return "".join(data) if isinstance(data, list) else str(data)
