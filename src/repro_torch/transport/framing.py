"""Length-prefixed message framing for the worker transport (DESIGN.md §13).

One frame on the wire is::

    [4-byte big-endian header length][JSON header][array payload bytes]

The JSON header carries the message metadata (``kind``, block id, …) plus
an array manifest: for every named tensor, its shape and byte length, in
manifest order.  Payloads are raw little-endian int64 — every field
element the protocol moves is an int64 residue, so the wire format needs
exactly one dtype and stays trivially interoperable between the thread
and process spawn modes.

The framing layer is deliberately dumb: no negotiation, no compression,
no partial frames.  Reliability lives one level up — the dealer's
deadline/retry/backoff bookkeeping (:mod:`repro.transport.dealer`) and
the protocol's own survivor-mask / elastic-replan tolerance decide what
a lost or late frame means.
"""
from __future__ import annotations

import json
import socket
import struct
from typing import Dict, Optional, Tuple

import numpy as np

from ..mpc.errors import InvariantError

#: framing protocol version, checked on every ``plan`` handshake
WIRE_VERSION = 1

#: refuse obviously-corrupt length prefixes before allocating buffers
MAX_HEADER_BYTES = 1 << 20
MAX_PAYLOAD_BYTES = 1 << 31

_LEN = struct.Struct(">I")


class TransportClosed(ConnectionError):
    """The peer closed the connection mid-frame (worker death / stop)."""


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise :class:`TransportClosed`."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            raise TransportClosed(f"peer closed after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def send_msg(sock: socket.socket, meta: Dict,
             arrays: Optional[Dict[str, np.ndarray]] = None) -> int:
    """Send one frame; returns the number of payload bytes written.

    ``arrays`` values are converted to C-contiguous little-endian int64
    before writing, so any exact integer array (numpy or jax-backed via
    ``np.asarray``) rides the same wire format.
    """
    manifest = []
    payloads = []
    for name, arr in (arrays or {}).items():
        # analysis: allow(host-sync): wire boundary, frames are host bytes
        a = np.ascontiguousarray(np.asarray(arr, dtype="<i8"))
        manifest.append({"name": name, "shape": list(a.shape),
                         "nbytes": int(a.nbytes)})
        payloads.append(a.tobytes())
    header = dict(meta)
    header["_arrays"] = manifest
    hb = json.dumps(header).encode()
    if len(hb) > MAX_HEADER_BYTES:
        raise InvariantError(f"frame header {len(hb)}B exceeds cap")
    body = b"".join(payloads)
    sock.sendall(_LEN.pack(len(hb)) + hb + body)
    return len(body)


def recv_msg(sock: socket.socket, *, timeout: Optional[float] = None
             ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Receive one frame as ``(meta, arrays)``.

    ``timeout`` (seconds) bounds the wait for the frame's *first* byte —
    ``socket.timeout`` propagates to the caller, whose deadline machinery
    owns the retry/evict decision.  A frame that has started arriving is
    read to completion under the same per-recv timeout.
    """
    sock.settimeout(timeout)
    (hlen,) = _LEN.unpack(_recv_exact(sock, 4))
    if hlen > MAX_HEADER_BYTES:
        raise TransportClosed(f"corrupt header length {hlen}")
    header = json.loads(_recv_exact(sock, hlen))
    manifest = header.pop("_arrays", [])
    total = sum(int(m["nbytes"]) for m in manifest)
    if total > MAX_PAYLOAD_BYTES:
        raise TransportClosed(f"corrupt payload length {total}")
    body = _recv_exact(sock, total) if total else b""
    arrays: Dict[str, np.ndarray] = {}
    off = 0
    for m in manifest:
        n = int(m["nbytes"])
        arrays[str(m["name"])] = np.frombuffer(
            body, dtype="<i8", count=n // 8, offset=off
        ).reshape([int(d) for d in m["shape"]]).astype(np.int64)
        off += n
    return header, arrays
