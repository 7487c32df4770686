"""API-key auth + sliding-window rate limiting as aiohttp middleware.

Reproduces the reference's security layer (vgate/security.py:42-251): Bearer
token extraction, per-key sliding windows of timestamps, 401 on
missing/invalid keys, 429 with ``X-RateLimit-*`` and ``Retry-After`` headers
when over the window limit, and exempt paths that skip both checks.  The
reference is FastAPI/Starlette middleware; here it is an aiohttp
``@middleware`` since this framework's HTTP layer is aiohttp-native.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from aiohttp import web

from vgate_tpu_torch.logging_config import get_logger
from vgate_tpu_torch.tracing import get_tracer

logger = get_logger(__name__)
tracer = get_tracer(__name__)


def extract_api_key(request: web.Request) -> Optional[str]:
    """Pull the Bearer token from the Authorization header
    (reference: vgate/security.py:116-136)."""
    auth = request.headers.get("Authorization", "")
    if auth.startswith("Bearer "):
        token = auth[len("Bearer "):].strip()
        return token or None
    return None


class RateLimiter:
    """Per-key sliding window over raw timestamps
    (reference: vgate/security.py:42-113).

    Windows are ``deque``s (O(1) expiry at the old end, vs the O(n)
    ``list.pop(0)`` this replaced), and keys whose window has fully
    expired are swept out once per window period — the key space is
    client-controlled (API keys / IPs), so an entry per distinct key
    forever is an unbounded-memory hole under key-rotating traffic."""

    def __init__(
        self,
        requests_per_minute: int = 60,
        per_key_limits: Optional[Dict[str, int]] = None,
        window_s: float = 60.0,
    ) -> None:
        self.default_limit = requests_per_minute
        self.per_key_limits = dict(per_key_limits or {})
        self.window_s = window_s
        self._windows: Dict[str, Deque[float]] = {}
        self._last_sweep = 0.0

    def limit_for(self, key: str) -> int:
        return self.per_key_limits.get(key, self.default_limit)

    def _sweep(self, now: float) -> None:
        """Drop keys with no timestamp inside the window.  O(total
        entries), amortized to once per window period."""
        cutoff = now - self.window_s
        for key in list(self._windows):
            window = self._windows[key]
            while window and window[0] <= cutoff:
                window.popleft()
            if not window:
                del self._windows[key]
        self._last_sweep = now

    def check(self, key: str, now: Optional[float] = None) -> Tuple[bool, Dict[str, str]]:
        """Record one request attempt.  Returns (allowed, headers)."""
        now = time.monotonic() if now is None else now
        if now - self._last_sweep >= self.window_s:
            self._sweep(now)
        window = self._windows.setdefault(key, deque())
        cutoff = now - self.window_s
        while window and window[0] <= cutoff:
            window.popleft()
        limit = self.limit_for(key)
        headers = {
            "X-RateLimit-Limit": str(limit),
            "X-RateLimit-Remaining": str(max(0, limit - len(window) - 1)),
        }
        if len(window) >= limit:
            retry_after = max(0.0, window[0] + self.window_s - now)
            headers["X-RateLimit-Remaining"] = "0"
            headers["Retry-After"] = str(int(retry_after) + 1)
            return False, headers
        window.append(now)
        return True, headers

    def get_stats(self) -> Dict[str, int]:
        return {key: len(win) for key, win in self._windows.items()}


def _error_json(status: int, message: str, err_type: str) -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": err_type}}, status=status
    )


def build_security_middleware(config) -> web.middleware:
    """Factory producing the auth+ratelimit middleware for one app instance
    (reference: SecurityMiddleware at vgate/security.py:139-251)."""
    rate_limiter = RateLimiter(
        requests_per_minute=config.rate_limit.requests_per_minute,
        per_key_limits=config.rate_limit.per_key_limits,
    )
    valid_keys = set(config.security.api_keys)
    exempt = set(config.security.exempt_paths)

    @web.middleware
    async def security_middleware(request: web.Request, handler):
        if not config.security.enabled or request.path in exempt:
            return await handler(request)
        with tracer.start_as_current_span("security.check"):
            key = extract_api_key(request)
            if key is None:
                return _error_json(
                    401, "Missing API key", "authentication_error"
                )
            if valid_keys and key not in valid_keys:
                return _error_json(
                    401, "Invalid API key", "authentication_error"
                )
            # downstream consumers (admission tier mapping, per-key
            # in-flight caps) read the authenticated key from here
            request["api_key"] = key
            if config.rate_limit.enabled:
                allowed, headers = rate_limiter.check(key)
                if not allowed:
                    resp = _error_json(
                        429, "Rate limit exceeded", "rate_limit_error"
                    )
                    resp.headers.update(headers)
                    return resp
                response = await handler(request)
                response.headers.update(headers)
                return response
            return await handler(request)

    security_middleware.rate_limiter = rate_limiter  # type: ignore[attr-defined]
    return security_middleware
