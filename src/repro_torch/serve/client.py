"""Async client for the posterior server's newline-delimited-JSON protocol.

The port's own copy of ``repro/serve/client.py`` (plain asyncio). One
request per line, one response per line, in order — so a single connection
is a serial query stream and concurrency comes from opening more
connections (what the probe pool in
:func:`repro_torch.serve.server.serve_pipeline` does: one connection per
concurrent reader).

    client = await ServeClient.connect(host, port)
    resp = await client.request("mean_cov", combiner="parametric")
    resp["result"]["mean"], resp["staleness"]["draws_seen"]
    await client.close()

:meth:`ServeClient.ask` additionally raises the typed :class:`ServeError`
on ``ok=False`` responses and returns just the ``result`` payload.
"""

from __future__ import annotations

import asyncio
import json
from typing import Any, Dict


class ServeError(RuntimeError):
    """An ``ok=False`` response, with the server's code/reason attached."""

    def __init__(self, error: Dict[str, Any], staleness: Dict[str, Any]):
        self.code = int(error.get("code", 500))
        self.reason = str(error.get("reason", "unknown"))
        self.staleness = staleness
        super().__init__(f"[{self.code}] {self.reason}")


class ServeClient:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self._reader = reader
        self._writer = writer
        self._lock = asyncio.Lock()  # serialize request/response pairs

    @classmethod
    async def connect(cls, host: str, port: int) -> "ServeClient":
        reader, writer = await asyncio.open_connection(host, port)
        return cls(reader, writer)

    async def request(self, op: str, **params: Any) -> Dict[str, Any]:
        """Send one request, return the raw response dict (ok or not)."""
        payload = json.dumps({"op": op, **params}).encode() + b"\n"
        async with self._lock:
            self._writer.write(payload)
            await self._writer.drain()
            line = await self._reader.readline()
        if not line:
            raise ConnectionError("server closed the connection")
        return json.loads(line)

    async def ask(self, op: str, **params: Any) -> Dict[str, Any]:
        """Like :meth:`request`, but raise :class:`ServeError` on failures
        and unwrap the ``result`` payload."""
        resp = await self.request(op, **params)
        if not resp.get("ok"):
            raise ServeError(resp.get("error", {}), resp.get("staleness", {}))
        return resp["result"]

    async def close(self) -> None:
        self._writer.close()
        try:
            await self._writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError):
            pass
