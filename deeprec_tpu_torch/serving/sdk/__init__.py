"""Client SDKs for the port's serving endpoint.

Port of ``deeprec_tpu/serving/sdk/``; the serving boundary is HTTP/JSON
(``serving.processor.HttpScorer``, and the worker behind the C ABI
processor), so the SDKs are thin clients of that wire protocol:

  * :class:`Client`: Python, standard library only (``client.py``).
  * ``c/deeprec_client.{h,c}``: C99 and POSIX sockets, for embedding in
    native RPC frameworks; compile it with the caller (``gcc -std=c99
    -I c main.c c/deeprec_client.c``).

Wire protocol: ``POST /v1/predict`` with ``{"instances": [...]}``
returns ``{"predictions": [...]}``; ``GET /healthz`` returns
``{"status": "ok", "version": N}``.
"""

from deeprec_tpu_torch.serving.sdk.client import Client, ServingError

__all__ = ["Client", "ServingError"]
