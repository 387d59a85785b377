"""paddle_tpu_torch.inference: the serving front door of the reference's
``paddle_tpu.inference``.

Only :func:`create_serving_endpoint` is ported.  The reference's
``Config``, ``Predictor``, ``PredictorPool`` and ``DistConfig`` serve
``jit.save`` artifacts and come with the port's saved programs (ROADMAP
§A4, §A5).
"""
from __future__ import annotations


def create_serving_endpoint(model, config=None, **generate_defaults):
    """A Predictor-shaped :class:`paddle_tpu_torch.serving.Endpoint`
    over a causal LM of this package, a prebuilt
    :class:`~paddle_tpu_torch.serving.Engine` or a
    :class:`~paddle_tpu_torch.serving.Router` fleet (``config`` must then
    be None: a prebuilt engine or router carries its config).
    ``config`` is a :class:`~paddle_tpu_torch.serving.ServingConfig`;
    ``generate_defaults`` (eos_token_id, max_new_tokens, ...) apply to
    every request unless a call overrides them."""
    from ..serving import Endpoint

    return Endpoint(model, config, **generate_defaults)


__all__ = ["create_serving_endpoint"]
