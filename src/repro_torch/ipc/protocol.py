"""Wire protocol for the node-level broker (repro_torch.ipc).

Pure user-space, no special permissions (the paper's constraint): framed
JSON over a Unix-domain stream socket. Every message is a 4-byte
big-endian length prefix followed by a UTF-8 JSON object with an ``op``
field. The framing is deliberately tiny — the broker exchanges a handful
of control messages per second, not data.

Client → broker ops (envelope v2; v1 differences noted inline)
    register    {name, share, slots, pid}      join the node lease table
                (``slots`` is the worker's registered width — the demand
                *ceiling*; 0 is legal: a pure best-effort process)
    heartbeat   {backlog?}                     liveness (and keepalive).
                v2 piggybacks ``backlog``: the sender's instantaneous
                runnable backlog (READY + RUNNING tasks), a non-negative
                int. The broker clamps it into [0, registered width] and
                feeds the demand model (hysteresis-damped effective
                want). v1 clients omit the field and keep the static
                contract: effective want == registered width. A present
                but malformed ``backlog`` (non-int, bool, or negative)
                is a protocol violation and costs the SENDER its
                connection — never the broker loop.
    resize      {share, slots?}                set this worker's share
                (and optionally its registered width)
    rescale     {scale}                        multiply share (mesh rescale)
    deregister  {}                             leave cleanly
    stats       {}                             request a table snapshot

Broker → client ops
    grant       {slots, quota, capacity, workers, epoch, incarnation}
                the worker's current node-slot grant (pushed when — and
                since envelope v2 *only* when — this worker's grant
                content changed; ``quota`` is the lease entitlement
                before work-conserving redistribution). Unchanged grants
                are not re-pushed: the idempotent copy riding every
                heartbeat ack is the refresh/healing path.
    snapshot    {...}                          reply to ``stats``

Version negotiation is deliberately absent: v2 is a pure superset (one
optional heartbeat field), so v1 clients and v2 brokers — and vice
versa — interoperate with static-demand semantics.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import tempfile
from typing import Optional

_LEN = struct.Struct(">I")

#: sanity cap — control messages are tiny; anything bigger is corruption
MAX_MSG = 1 << 20


class ProtocolError(RuntimeError):
    pass


def send_msg(sock: socket.socket, msg: dict) -> None:
    """Frame and send one message (atomic wrt other senders only if the
    caller serializes — both endpoints hold a send lock)."""
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    sock.sendall(_LEN.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes; None on clean EOF at a frame boundary."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            if got == 0:
                return None
            raise ProtocolError(f"EOF mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Optional[dict]:
    """Receive one framed message; None on clean EOF (peer closed)."""
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > MAX_MSG:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_MSG")
    body = _recv_exact(sock, n)
    if body is None:
        raise ProtocolError("EOF between header and body")
    return json.loads(body.decode("utf-8"))


class FrameDecoder:
    """Incremental decoder for the broker's non-blocking event loop: feed
    raw bytes, pop complete messages."""

    __slots__ = ("_buf",)

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> list[dict]:
        self._buf.extend(data)
        out: list[dict] = []
        buf = self._buf
        while True:
            if len(buf) < _LEN.size:
                break
            (n,) = _LEN.unpack(buf[: _LEN.size])
            if n > MAX_MSG:
                raise ProtocolError(f"frame of {n} bytes exceeds MAX_MSG")
            if len(buf) < _LEN.size + n:
                break
            body = bytes(buf[_LEN.size: _LEN.size + n])
            del buf[: _LEN.size + n]
            out.append(json.loads(body.decode("utf-8")))
        return out


def default_socket_path(tag: str = "node") -> str:
    """A per-user default rendezvous path (pure user-space: no /var/run)."""
    return os.path.join(
        tempfile.gettempdir(), f"usf-broker-{tag}-{os.getuid()}.sock"
    )
