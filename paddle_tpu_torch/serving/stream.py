"""Server-sent-events framing over the serving engine (the port of
``paddle_tpu/serving/stream.py``).  An SSE response is an iterator of
``data: <json>\\n\\n`` frames, which is what this module yields, so any
WSGI/ASGI shim (or a test) can drain it.  Tokens arrive through the
engine's ``on_token`` callback (``Engine.submit(on_token=...)``, once
per token, in order).
"""
from __future__ import annotations

import json
from collections import deque
from typing import Iterator

from .scheduler import FINISHED

DONE_FRAME = "data: [DONE]\n\n"


def sse_event(payload) -> str:
    """One SSE frame: ``data: <compact json>`` and a blank line."""
    return f"data: {json.dumps(payload, separators=(',', ':'))}\n\n"


def stream_events(target, prompt, **submit_kwargs) -> Iterator[dict]:
    """Submit ``prompt`` and yield ``{"token": id, "index": i}`` for each
    generated token while driving the engine, then a summary
    ``{"finish_reason": ..., "num_tokens": ..., "request_id": ...}``.

    ``target`` is anything engine-shaped: an :class:`Engine` (driven by
    ``step``) or an :class:`~paddle_tpu_torch.serving.endpoint.Endpoint`
    (driven by ``poll``).  Other requests in flight keep making progress:
    each tick is the engine's ordinary iteration."""
    tick = getattr(target, "poll", None) or target.step
    buf: deque = deque()
    req = target.submit(prompt, on_token=buf.append, **submit_kwargs)
    index = 0
    while True:
        while buf:
            yield {"token": int(buf.popleft()), "index": index}
            index += 1
        if req.state == FINISHED:
            break
        if not tick() and not buf and req.state != FINISHED:
            break           # the engine drained without finishing it
    while buf:
        yield {"token": int(buf.popleft()), "index": index}
        index += 1
    yield {"finish_reason": req.finish_reason, "num_tokens": index,
           "request_id": req.request_id}


def sse_stream(target, prompt, **submit_kwargs) -> Iterator[str]:
    """:func:`stream_events` framed as SSE ``data:`` lines, ending with
    the ``data: [DONE]`` sentinel."""
    for event in stream_events(target, prompt, **submit_kwargs):
        yield sse_event(event)
    yield DONE_FRAME
