"""Prometheus text-exposition (0.0.4) parsing + invariant checks.

The port's own copy of ``kaito_tpu/utils/promtext.py``, so that
``chip_smoke.py`` can parse the port's ``/metrics`` on a machine
without the JAX package.

``parse_exposition`` is deliberately STRICT — every non-comment line
must be a well-formed sample — because a payload our own toolkit
emitted should never need lenient parsing; leniency would hide exactly
the formatting regressions this module exists to catch.  Errors raise
``ValueError`` (callers that scrape over the network treat that as a
failed scrape).
"""

from __future__ import annotations

import math
import re

# one full sample line: name, optional {labels}, value
SAMPLE_RE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})? "
    r"(-?(?:[0-9.]+(?:e[+-]?[0-9]+)?|inf|nan))$",
    re.IGNORECASE)
_LE_RE = re.compile(r'le="([^"]*)"')
_LABEL_RE = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')

Sample = tuple  # (name, labels_str, value)


def parse_exposition(text: str) -> list[Sample]:
    """Parse a full exposition payload.  Every non-comment, non-blank
    line must be a valid sample; returns ``[(name, labels_str,
    float_value)]`` (``labels_str`` is ``""`` for unlabelled samples).
    Raises ``ValueError`` on the first unparseable line."""
    samples: list[Sample] = []
    for line in text.splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        m = SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        samples.append((m.group(1), m.group(2) or "", float(m.group(3))))
    return samples


def parse_labels(labels_str: str) -> dict[str, str]:
    """``'{a="x",le="+Inf"}'`` -> ``{"a": "x", "le": "+Inf"}`` with the
    writer's escapes (``\\\\``, ``\\"``, ``\\n``) undone."""
    out: dict[str, str] = {}
    for name, raw in _LABEL_RE.findall(labels_str or ""):
        out[name] = (raw.replace("\\n", "\n").replace('\\"', '"')
                     .replace("\\\\", "\\"))
    return out


def check_histograms(samples: list[Sample], require: bool = True) -> dict:
    """For every histogram family present: cumulative buckets must be
    monotone in ``le`` and the ``+Inf`` bucket must equal ``_count``.
    Returns ``{(family, labels_without_le): [(le, value), ...]}``;
    raises ``ValueError`` on any violation (or, when ``require``, on a
    payload with no histograms at all)."""
    series: dict[tuple, list] = {}
    for name, labels, value in samples:
        if not name.endswith("_bucket"):
            continue
        le_m = _LE_RE.search(labels)
        if le_m is None:
            raise ValueError(f"{name}{labels}: bucket without le label")
        le = le_m.group(1)
        rest = _LE_RE.sub("", labels).replace(",}", "}").replace("{,", "{")
        if rest == "{}":
            rest = ""                          # unlabelled family
        series.setdefault((name[:-len("_bucket")], rest), []).append(
            (math.inf if le == "+Inf" else float(le), value))
    if require and not series:
        raise ValueError("no histogram buckets in payload")
    counts = {(n, lbl): v for n, lbl, v in samples if n.endswith("_count")}
    for (fam, rest), buckets in series.items():
        buckets.sort()
        if buckets[-1][0] != math.inf:
            raise ValueError(f"{fam}: missing +Inf bucket")
        values = [v for _, v in buckets]
        if values != sorted(values):
            raise ValueError(f"{fam}{rest}: non-monotone buckets")
        count = counts.get((fam + "_count", rest))
        if count is None:
            raise ValueError(f"{fam}{rest}: missing _count")
        if buckets[-1][1] != count:
            raise ValueError(f"{fam}{rest}: +Inf != _count")
    return series
