"""Socket transport for the processes backend: framing + wire codec +
rendezvous.  Frames are the JAX package's ``runtime/transport.py`` byte
for byte, so workers of either package speak the same wire.

## Frame protocol

Every message is one length-prefixed binary frame on a TCP stream:

    !BI   frame type (uint8), body length (uint32)   then the body.

Types: ``ROWS`` (a round's gossip payload for a set of node rows),
``HEARTBEAT`` (the failure detector's liveness beacon), ``BYE`` (graceful
leave — the join/leave protocol's clean half; a SIGKILL'd worker never
sends one, which is exactly how the two are told apart), and the elastic
membership control plane: ``JOIN`` (a relaunched incarnation announces
itself — hello phase carries its new endpoint, commit phase the round it
will rejoin at), ``WELCOME`` (a survivor's reply: its current round and
epoch, plus the ack/nack of a commit), ``STATE_REQ``/``STATE`` (cold
catch-up: a rejoiner with no checkpoint pulls a live donor's current
row-block — the STATE body reuses the ROWS codec verbatim).

Every frame is stamped with the sender's **membership epoch** (its
incarnation number: 0 at first launch, +1 per supervisor relaunch), so
a receiver can reject a pre-crash zombie's stale frames with one integer
compare — see ``runtime.membership``.

## ROWS body — the payload wire format, serialized

    !IHHHBI round, sender worker id, sender epoch, n_rows, fmt, k_or_p
    ids     (n_rows,) int32 global node ids

then per format:

* ``FMT_FULL_F32``    — (n_rows, P) fp32 parameter rows (D-PSGD).
* ``FMT_PAYLOAD_F32`` — (n_rows, k) int32 coordinate indices +
  (n_rows, k) fp32 values (the randomk (idx, val) payload).
* ``FMT_PAYLOAD_I8``  — (n_rows,) fp32 scale header + (n_rows, k) int32
  indices + (n_rows, k) int8 codes (``compression.quantize_int8`` on the
  wire: 1 byte/value + one fp32 scale per node).

Encode/decode are plain numpy ``tobytes``/``frombuffer`` — no pickling,
so a corrupt or truncated frame fails loudly at a struct/length check.
A frame is never split: ``encode_rows`` raises for more than 65,535 rows
(``n_rows`` is a uint16) or a body over ``MAX_FRAME_BYTES``.

## Rendezvous

A newline-delimited-JSON registry (hosted by the launcher): each worker
connects, registers ``{worker, host, port}`` for its listening socket,
and blocks until the server broadcasts the full peer map once all K
workers are in.  Late (re)connections get the map immediately.
"""
from __future__ import annotations

import asyncio
import json
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

MSG_ROWS = 1
MSG_HEARTBEAT = 2
MSG_BYE = 3
MSG_JOIN = 4
MSG_WELCOME = 5
MSG_STATE_REQ = 6
MSG_STATE = 7

FMT_FULL_F32 = 0
FMT_PAYLOAD_F32 = 1
FMT_PAYLOAD_I8 = 2

_FRAME = struct.Struct("!BI")
_ROWS_HDR = struct.Struct("!IHHHBI")
_WID = struct.Struct("!H")
_PEER = struct.Struct("!HH")

MAX_FRAME_BYTES = 1 << 30  # sanity bound: a longer length prefix is garbage


# ----------------------------------------------------------------------
# frame codec
# ----------------------------------------------------------------------
def encode_rows(rnd: int, sender: int, ids: np.ndarray, fmt: int,
                *, epoch: int = 0,
                rows: Optional[np.ndarray] = None,
                idx: Optional[np.ndarray] = None,
                val: Optional[np.ndarray] = None,
                codes: Optional[np.ndarray] = None,
                scale: Optional[np.ndarray] = None) -> bytes:
    """ROWS frame body for ``ids`` (global node ids).  ``rows`` is the
    (n, P) fp32 matrix for FMT_FULL_F32; ``idx``/``val`` the (n, k)
    payload for FMT_PAYLOAD_F32; ``idx``/``codes``/``scale`` for
    FMT_PAYLOAD_I8.  ``epoch`` is the sender's membership epoch."""
    ids = np.ascontiguousarray(ids, np.int32)
    n = len(ids)
    if fmt == FMT_FULL_F32:
        rows = np.ascontiguousarray(rows, np.float32)
        kp, tail = rows.shape[1], rows.tobytes()
    elif fmt == FMT_PAYLOAD_F32:
        idx = np.ascontiguousarray(idx, np.int32)
        val = np.ascontiguousarray(val, np.float32)
        kp, tail = idx.shape[1], idx.tobytes() + val.tobytes()
    elif fmt == FMT_PAYLOAD_I8:
        idx = np.ascontiguousarray(idx, np.int32)
        codes = np.ascontiguousarray(codes, np.int8)
        scale = np.ascontiguousarray(scale, np.float32).reshape(n)
        kp = idx.shape[1]
        tail = scale.tobytes() + idx.tobytes() + codes.tobytes()
    else:
        raise ValueError(f"unknown ROWS fmt {fmt}")
    if n > 0xFFFF:
        raise ValueError(f"ROWS frame of {n} rows: the header holds at most 65535")
    size = _ROWS_HDR.size + ids.nbytes + len(tail)
    if size > MAX_FRAME_BYTES:
        raise ValueError(f"ROWS frame of {size} bytes exceeds MAX_FRAME_BYTES "
                         f"({MAX_FRAME_BYTES})")
    return (_ROWS_HDR.pack(rnd, sender, epoch, n, fmt, kp)
            + ids.tobytes() + tail)


def decode_rows(body: bytes) -> Dict:
    """Inverse of :func:`encode_rows`; raises on a malformed body."""
    rnd, sender, epoch, n, fmt, kp = _ROWS_HDR.unpack_from(body)
    off = _ROWS_HDR.size
    ids = np.frombuffer(body, np.int32, n, off)
    off += 4 * n
    out = {"round": rnd, "sender": sender, "epoch": epoch, "ids": ids,
           "fmt": fmt}
    if fmt == FMT_FULL_F32:
        out["rows"] = np.frombuffer(body, np.float32, n * kp, off).reshape(n, kp)
        off += 4 * n * kp
    elif fmt == FMT_PAYLOAD_F32:
        out["idx"] = np.frombuffer(body, np.int32, n * kp, off).reshape(n, kp)
        off += 4 * n * kp
        out["val"] = np.frombuffer(body, np.float32, n * kp, off).reshape(n, kp)
        off += 4 * n * kp
    elif fmt == FMT_PAYLOAD_I8:
        out["scale"] = np.frombuffer(body, np.float32, n, off)
        off += 4 * n
        out["idx"] = np.frombuffer(body, np.int32, n * kp, off).reshape(n, kp)
        off += 4 * n * kp
        out["codes"] = np.frombuffer(body, np.int8, n * kp, off).reshape(n, kp)
        off += n * kp
    else:
        raise ValueError(f"unknown ROWS fmt {fmt}")
    if off != len(body):
        raise ValueError(
            f"ROWS frame length mismatch: decoded {off} of {len(body)} bytes"
        )
    return out


def encode_wid(wid: int) -> bytes:
    return _WID.pack(wid)


def decode_wid(body: bytes) -> int:
    return _WID.unpack(body)[0]


def encode_peer(wid: int, epoch: int) -> bytes:
    """HEARTBEAT/BYE body: (worker id, membership epoch)."""
    return _PEER.pack(wid, epoch)


def decode_peer(body: bytes) -> Tuple[int, int]:
    return _PEER.unpack(body)


def encode_json(obj: Dict) -> bytes:
    """JOIN/WELCOME/STATE_REQ control-plane body (low-rate, so JSON)."""
    return json.dumps(obj).encode()


def decode_json(body: bytes) -> Dict:
    return json.loads(body.decode())


async def write_frame(writer: asyncio.StreamWriter, ftype: int, body: bytes):
    writer.write(_FRAME.pack(ftype, len(body)) + body)
    await writer.drain()


async def read_frame(reader: asyncio.StreamReader) -> Tuple[int, bytes]:
    """(type, body) of the next frame; raises IncompleteReadError on EOF."""
    hdr = await reader.readexactly(_FRAME.size)
    ftype, ln = _FRAME.unpack(hdr)
    if ln > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {ln} exceeds sanity bound")
    return ftype, await reader.readexactly(ln)


async def open_with_retry(host: str, port: int, *, attempts: int = 40,
                          delay_s: float = 0.1) -> Tuple[
                              asyncio.StreamReader, asyncio.StreamWriter]:
    """Dial a peer that may not be listening yet (slow joiner): flat retry
    during the join window — exponential backoff is for mid-run failures
    (``faults.retry_backoff_delay``), not for startup races."""
    last: Optional[Exception] = None
    for _ in range(attempts):
        try:
            return await asyncio.open_connection(host, port)
        except OSError as e:
            last = e
            await asyncio.sleep(delay_s)
    raise ConnectionError(f"could not reach {host}:{port}: {last}")


# ----------------------------------------------------------------------
# rendezvous registry
# ----------------------------------------------------------------------
class RendezvousServer:
    """Launcher-hosted peer registry on its own event-loop thread.

    Workers register their listening endpoint; once all K are in, every
    registered (and any later) connection receives the full peer map.
    The server stays up for the whole run so a reconnecting worker can
    re-fetch the map."""

    def __init__(self, n_workers: int, host: str = "127.0.0.1"):
        self.n = n_workers
        self.host = host
        self.port: Optional[int] = None
        self._peers: Dict[int, Tuple[str, int]] = {}
        self._waiting = []
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._ready = threading.Event()

    def start(self) -> Tuple[str, int]:
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if not self._ready.wait(timeout=10):
            raise RuntimeError("rendezvous server failed to start")
        return self.host, self.port

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- loop thread ----------------------------------------------------
    def _run(self):
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)

        async def boot():
            server = await asyncio.start_server(self._serve, self.host, 0)
            self.port = server.sockets[0].getsockname()[1]
            self._ready.set()

        loop.run_until_complete(boot())
        loop.run_forever()

    def _peer_map(self) -> bytes:
        m = {str(w): [h, p] for w, (h, p) in self._peers.items()}
        return (json.dumps({"peers": m}) + "\n").encode()

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter):
        try:
            line = await reader.readline()
            if not line:
                return
            msg = json.loads(line)
            self._peers[int(msg["worker"])] = (msg["host"], int(msg["port"]))
            if len(self._peers) >= self.n:
                for w in self._waiting:
                    try:
                        w.write(self._peer_map())
                        await w.drain()
                    except OSError:
                        pass
                self._waiting.clear()
                writer.write(self._peer_map())
                await writer.drain()
            else:
                self._waiting.append(writer)
                return  # keep open; broadcast resolves it
        except (json.JSONDecodeError, KeyError, ValueError, OSError):
            pass


async def rendezvous_register(host: str, port: int, worker: int,
                              my_host: str, my_port: int, *,
                              timeout_s: float = 30.0,
                              ) -> Dict[int, Tuple[str, int]]:
    """Register this worker's endpoint and block until the registry
    responds with the full peer map (all K workers joined)."""
    reader, writer = await open_with_retry(host, port)
    writer.write((json.dumps(
        {"worker": worker, "host": my_host, "port": my_port}) + "\n").encode())
    await writer.drain()
    line = await asyncio.wait_for(reader.readline(), timeout=timeout_s)
    writer.close()
    if not line:
        raise ConnectionError("rendezvous closed before the peer map arrived")
    peers = json.loads(line)["peers"]
    return {int(w): (h, int(p)) for w, (h, p) in peers.items()}


def free_port(host: str = "127.0.0.1") -> int:
    """An OS-assigned free TCP port (for tests that need one up front)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
