"""The port's HTTP gateway (aiohttp), serving the OpenAI-compatible API
over the torch engine."""

from vgate_tpu_torch.server.app import create_app

__all__ = ["create_app"]
