"""The engine config the JAX server's ``main`` builds for a command line.

``kaito_tpu.engine.server.main`` builds its ``EngineConfig`` inline:
:func:`jax_main_config` runs that ``main`` with ``EngineConfig``
replaced by a recorder that stops it there, and returns the keyword
arguments it was given.  With ``accelerator=True`` JAX reports a TPU as
its first device, so the defaults that follow the platform (``--dtype``
and the KV dtype: bfloat16 on an accelerator, float32 on the CPU) are the
ones the JAX server takes on its accelerator, as the port's server takes
bfloat16 on the card.
"""

import types

import jax
import pytest

import kaito_tpu.engine.server as jax_server


class _Parsed(Exception):
    pass


def jax_main_config(monkeypatch, argv, accelerator=False) -> dict:
    def record(**kw):
        raise _Parsed(kw)

    with monkeypatch.context() as m:
        m.setattr(jax_server, "EngineConfig", record)
        if accelerator:
            m.setattr(jax, "devices",
                      lambda *a, **k: [types.SimpleNamespace(platform="tpu")])
        with pytest.raises(_Parsed) as got:
            jax_server.main(list(argv))
    return got.value.args[0]
