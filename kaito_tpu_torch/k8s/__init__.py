"""The controller layer's Kubernetes pieces: event recording
(``events.py``).  The wire codec, the REST client and the Store adapter
that speaks to an API server (``kaito_tpu.k8s.{codec,client,store}``)
are not ported yet (ROADMAP queue 1, item 1)."""

from kaito_tpu_torch.k8s.events import EventRecorder, record_event

__all__ = ["EventRecorder", "record_event"]
