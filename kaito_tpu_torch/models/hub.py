"""Config fetching for ``org/model`` ids that are not built-in presets.

A copy of ``kaito_tpu.models.hub``, wired into the port's registry:

- ``catalog_config(hf_id)``: the committed catalog
  (``model_catalog.json`` beside this module, recorded public
  ``config.json`` dicts), so popular models resolve with no egress and
  air-gapped clusters still serve them.
- ``fetch_hf_config(hf_id)``: a stdlib HTTPS fetch of
  ``https://huggingface.co/<id>/resolve/main/config.json`` with
  ``HF_TOKEN`` / ``HUGGING_FACE_HUB_TOKEN`` auth and bounded retries;
  ``HF_HUB_OFFLINE`` turns it off.
- ``default_config_fetcher``: the catalog first, the hub second, with a
  negative cache; :func:`install_default_fetcher` installs it into
  :func:`kaito_tpu_torch.models.registry.set_config_fetcher`, so
  ``get_model_by_name`` turns any ``org/model`` id into metadata.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.error
import urllib.request
from typing import Mapping, Optional

logger = logging.getLogger(__name__)

_CATALOG_PATH = os.path.join(os.path.dirname(__file__), "model_catalog.json")
_catalog: Optional[dict] = None

HUB_URL = "https://huggingface.co/{hf_id}/resolve/main/config.json"

# negative cache: a retry loop must not block again on an unresolvable
# model id every time it asks (a mistyped id asks forever)
_NEG_TTL_S = 300.0
_neg_cache: dict[str, float] = {}


def _load_catalog() -> dict:
    """Catalog indexed by lowercased HF id (built once)."""
    global _catalog
    if _catalog is None:
        try:
            with open(_CATALOG_PATH) as f:
                raw = json.load(f)
            _catalog = {k.lower(): v for k, v in raw.items()
                        if isinstance(v, dict)}
        except Exception:
            logger.exception("model catalog unreadable at %s", _CATALOG_PATH)
            _catalog = {}
    return _catalog


def catalog_config(hf_id: str) -> Optional[Mapping]:
    """Recorded config for a catalogued model (case-insensitive id)."""
    entry = _load_catalog().get(hf_id.lower())
    return entry.get("config") if entry else None


def fetch_hf_config(hf_id: str, timeout: float = 15.0,
                    retries: int = 3) -> Optional[Mapping]:
    """GET the model's config.json from the HF Hub (None on failure).
    Honors ``HF_HUB_OFFLINE``: air-gapped clusters fail fast instead of
    spending retry timeouts.  401, 403 and 404 are final; anything else
    is retried up to ``retries`` attempts."""
    if os.environ.get("HF_HUB_OFFLINE", "") not in ("", "0"):
        logger.info("HF_HUB_OFFLINE set; not fetching %s", hf_id)
        return None
    url = HUB_URL.format(hf_id=hf_id)
    headers = {"User-Agent": "kaito-tpu/preset-generator"}
    token = os.environ.get("HF_TOKEN") \
        or os.environ.get("HUGGING_FACE_HUB_TOKEN")
    if token:
        headers["Authorization"] = f"Bearer {token}"
    for attempt in range(retries):
        try:
            req = urllib.request.Request(url, headers=headers)
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code in (401, 403, 404):
                logger.warning("hub config for %s: HTTP %d", hf_id, e.code)
                return None
            logger.warning("hub config for %s: HTTP %d (attempt %d)",
                           hf_id, e.code, attempt + 1)
        except Exception as e:
            logger.warning("hub config for %s: %s (attempt %d)",
                           hf_id, e, attempt + 1)
        if attempt + 1 < retries:
            time.sleep(min(2.0 ** attempt, 8.0))
    return None


def default_config_fetcher(hf_id: str) -> Optional[Mapping]:
    """Catalog first (no egress), HF Hub second; failures are
    negative-cached for ``_NEG_TTL_S`` so repeated asks fail fast."""
    cfg = catalog_config(hf_id)
    if cfg is not None:
        logger.info("preset config for %s served from the catalog", hf_id)
        return cfg
    last_fail = _neg_cache.get(hf_id.lower())
    if last_fail is not None and time.monotonic() - last_fail < _NEG_TTL_S:
        return None
    cfg = fetch_hf_config(hf_id)
    if cfg is None:
        _neg_cache[hf_id.lower()] = time.monotonic()
    return cfg


def install_default_fetcher() -> None:
    """Wire :func:`default_config_fetcher` into the port's registry, so
    an ``org/model`` id that is no built-in preset resolves through the
    catalog and the hub."""
    from kaito_tpu_torch.models.registry import set_config_fetcher

    set_config_fetcher(default_config_fetcher)
    logger.info("preset auto-generation fetcher installed (catalog + HF hub)")
