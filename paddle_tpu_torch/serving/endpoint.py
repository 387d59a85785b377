"""``serving.Endpoint``: the Predictor-shaped front door to the
continuous-batching engine (the port of ``paddle_tpu/serving/endpoint.py``).

Two ways to use it:

- Predictor parity: ``get_input_handle("input_0").copy_from_cpu(ids)``,
  ``run()``, ``get_output_handle("output_0").copy_to_cpu()``: one
  rectangular batch in, an EOS-padded rectangular batch out;
- streaming: ``submit()`` / ``poll()`` / ``drain()`` / ``stream()`` for
  callers that want requests admitted and retired at token granularity.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .engine import Engine, ServingConfig
from .scheduler import FINISHED, Request


class Endpoint:
    """``model`` is a causal LM of this package (an :class:`Engine` is
    built from it with ``config``), an :class:`Engine`, or a
    :class:`~paddle_tpu_torch.serving.router.Router` fleet: the router
    has the engine's submit / step / run_until_complete / health
    surface, so everything below serves a fleet, and ``health()``
    reports the fleet's."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 **generate_defaults):
        from .router import Router

        if isinstance(model, (Engine, Router)):
            if config is not None:
                raise ValueError(
                    "pass ServingConfig when Endpoint builds the engine "
                    "from a model; a prebuilt Engine/Router already "
                    "carries its config")
            self.engine = model
        else:
            self.engine = Engine(model, config)
        self._defaults = generate_defaults
        self._inputs: Dict[str, np.ndarray] = {}
        self._outputs: Dict[str, np.ndarray] = {}

    # ------------------------------------------------- Predictor parity
    def get_input_names(self) -> List[str]:
        return ["input_0"]

    def get_output_names(self) -> List[str]:
        return ["output_0"]

    def get_input_handle(self, name: str) -> "_Handle":
        return _Handle(self._inputs, name)

    def get_output_handle(self, name: str) -> "_Handle":
        return _Handle(self._outputs, name)

    def run(self, prompts=None, **generate_kwargs) -> List[np.ndarray]:
        """Serve a batch (a list or array of prompts, or the ``input_0``
        handle's) and return each request's prompt + tokens in submit
        order; ``output_0`` holds them as a [B, T] array padded with
        ``eos_token_id`` (0 without one)."""
        if prompts is None:
            prompts = self._inputs.get("input_0")
            if prompts is None:
                raise ValueError("no prompts: pass run(prompts) or "
                                 "copy_from_cpu into input_0")
        kwargs = {**self._defaults, **generate_kwargs}
        outs = self.engine.generate([np.asarray(p).reshape(-1)
                                     for p in prompts], **kwargs)
        pad = kwargs.get("eos_token_id") or 0
        width = max(o.size for o in outs)
        rect = np.full((len(outs), width), pad, np.int32)
        for i, o in enumerate(outs):
            rect[i, :o.size] = o
        self._outputs["output_0"] = rect
        return outs

    # --------------------------------------------------------- streaming
    def submit(self, prompt, **kwargs) -> Request:
        return self.engine.submit(prompt, **{**self._defaults, **kwargs})

    def poll(self) -> bool:
        """One engine iteration; True while work remains."""
        return self.engine.step()

    def drain(self) -> Dict[str, Request]:
        return self.engine.run_until_complete()

    def stream(self, prompt, **kwargs):
        """The SSE response for ``prompt``: ``data: <json>`` frames, one
        a token, then a summary and ``[DONE]``
        (:mod:`paddle_tpu_torch.serving.stream`).  The engine keeps
        serving the other requests in flight while the caller drains."""
        from .stream import sse_stream
        return sse_stream(self, prompt, **{**self._defaults, **kwargs})

    def result(self, req: Request) -> Optional[np.ndarray]:
        return req.output_ids() if req.state == FINISHED else None

    def metrics(self) -> dict:
        return self.engine.stats()

    def health(self) -> dict:
        """Engine health snapshot (``Engine.health()``): the overload
        controller's state, degradation level, watchdog totals, latency
        EWMAs, queue depth and KV pressure, for a load balancer's probe;
        over a router, the fleet's (``Router.health()``)."""
        return self.engine.health()


class _Handle:
    """A ZeroCopyTensor-shaped view of one of an Endpoint's io dicts."""

    def __init__(self, store: dict, name: str):
        self._store = store
        self.name = name

    def reshape(self, shape):
        pass

    def copy_from_cpu(self, data):
        self._store[self.name] = np.asarray(data)

    def copy_to_cpu(self) -> np.ndarray:
        return np.asarray(self._store[self.name])

    @property
    def shape(self):
        a = self._store.get(self.name)
        return list(a.shape) if a is not None else None
