"""Live enhancement server: TCP sessions -> BatchedStreamingEnhancer (port of
``aas_enhancement_tpu/serve.py``).

Every connected session's next block is batched into ONE device call per
tick (``streaming.BatchedStreamingEnhancer``, or with an acoustic model
``streaming_asr.BatchedStreamingRecognizer``), so concurrent streams share
the card's launches instead of each paying for its own.  Standard library
sockets and threads only.

Wire protocol (both directions, little-endian), byte for byte the JAX
server's:
  frame  := uint32 n_bytes | n_bytes of float32 samples
  n_bytes == 0 is the end-of-stream marker.  A client streams capture audio
  as frames, sends the empty frame when done, and reads enhanced frames until
  it receives the empty frame back.  If all stream slots are busy the server
  answers a new connection with the empty frame immediately and closes.

Threading model: per-connection reader threads only BUFFER samples
(``eng.feed``); one ticker thread owns ALL device work (``eng.step``) and
routes each slot's output to its socket, sending outside the lock; the
engine is never called concurrently.  On the card the constructor makes one
device call over idle rows first (``warm``), so the kernels build and launch
in the caller's thread and a failure there raises from the constructor.  An
exception in the ticker stops the server: every session gets the
end-of-stream frame and is closed, no new one is taken, and ``stop()`` and
``check()`` re-raise it.  No session waits on a dead ticker.
"""

from __future__ import annotations

import socket
import struct
import threading

import numpy as np
import torch

from aas_enhancement_tpu_torch.config import Config
from aas_enhancement_tpu_torch.models.am import AcousticModel
from aas_enhancement_tpu_torch.models.enhancer import Enhancer
from aas_enhancement_tpu_torch.streaming import BatchedStreamingEnhancer
from aas_enhancement_tpu_torch.streaming_asr import BatchedStreamingRecognizer

_HDR = struct.Struct("<I")


def send_frame(sock: socket.socket, samples: np.ndarray) -> None:
    data = np.ascontiguousarray(samples, np.float32).tobytes()
    sock.sendall(_HDR.pack(len(data)) + data)


def send_eos(sock: socket.socket) -> None:
    sock.sendall(_HDR.pack(0))


def recv_frame_bytes(sock: socket.socket) -> bytes | None:
    """-> one frame's payload, or None on end-of-stream / closed socket."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    (n,) = _HDR.unpack(hdr)
    if n == 0:
        return None
    return _recv_exact(sock, n)


def recv_frame(sock: socket.socket) -> np.ndarray | None:
    """-> float32 samples, or None on end-of-stream / closed socket."""
    data = recv_frame_bytes(sock)
    return None if data is None else np.frombuffer(data, np.float32)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except OSError:
            return None
        if not chunk:
            return None
        buf += chunk
    return buf


def _hang_up(sock: socket.socket) -> None:
    """Shut a socket down and close it: a thread blocked in its recv or
    accept returns."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass                                  # not connected, or already shut
    sock.close()


class EnhanceServer:
    """Serve live enhancement sessions over TCP (see module docstring).

    With ``am`` the server TRANSCRIBES instead: sessions run through
    ``BatchedStreamingRecognizer`` (``model``, if any, then the AM per block)
    and the frames sent back carry UTF-8 transcript DELTAS (greedy CTC
    collapse is append-only across blocks, so the client concatenates
    them).  The networks live on ``device`` (the card by default; without a
    GPU that raises, pass ``"cpu"``)."""

    def __init__(self, cfg: Config, model: Enhancer | None, host: str = "127.0.0.1",
                 port: int = 0, max_streams: int = 8, chunk_seconds: float = 1.0,
                 lookahead_seconds: float = 0.2, history_seconds: float = 0.5,
                 tick_seconds: float = 0.02, am: AcousticModel | None = None,
                 device: torch.device | str = "cuda"):
        self._transcribe = am is not None
        kw = dict(max_streams=max_streams, chunk_seconds=chunk_seconds,
                  lookahead_seconds=lookahead_seconds, history_seconds=history_seconds,
                  device=device)
        if self._transcribe:
            self._eng = BatchedStreamingRecognizer(cfg, am, model, **kw)
            self._sent: dict[int, int] = {}   # chars already sent per slot
        else:
            self._eng = BatchedStreamingEnhancer(cfg, model, **kw)
        self._eng.warm()
        self._lock = threading.Lock()        # guards _eng state, _socks, _error
        self._socks: dict[int, socket.socket] = {}
        self._tick = tick_seconds
        self._stop = threading.Event()
        self._error: Exception | None = None
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._threads: list[threading.Thread] = []

    def start(self) -> "EnhanceServer":
        for fn in (self._accept_loop, self._tick_loop):
            t = threading.Thread(target=fn, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        """Stop serving and hang up every session; re-raises the ticker's
        exception if it failed."""
        self._stop.set()
        _hang_up(self._srv)
        with self._lock:
            socks = list(self._socks.values())
            self._socks.clear()
        for sock in socks:
            _hang_up(sock)
        for t in self._threads:
            t.join(timeout=5.0)
        self.check()

    def check(self) -> None:
        """Re-raise the exception that stopped the ticker, if one did."""
        if self._error is not None:
            raise self._error

    # ------------------------------------------------------------- internals
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                sock, _ = self._srv.accept()
            except OSError:
                return                        # server socket closed
            with self._lock:
                slot = None
                if not self._stop.is_set():
                    try:
                        slot = self._eng.open()
                    except RuntimeError:
                        pass                  # full: refuse politely
                if slot is not None:
                    self._socks[slot] = sock
                    if self._transcribe:
                        self._sent[slot] = 0
            if slot is None:
                try:
                    send_eos(sock)
                except OSError:
                    pass
                finally:
                    sock.close()
                continue
            t = threading.Thread(target=self._reader, args=(slot, sock), daemon=True)
            t.start()
            self._threads.append(t)

    def _reader(self, slot: int, sock: socket.socket) -> None:
        while True:
            samples = recv_frame(sock)
            with self._lock:
                # Identity check: the ticker may have closed this slot and a
                # NEW session reused the id — never feed someone else's stream.
                if self._socks.get(slot) is not sock:
                    return
                if samples is None:
                    self._eng.end_stream(slot)
                    return
                self._eng.feed(slot, samples)

    def _tick_loop(self) -> None:
        try:
            while not self._stop.is_set():
                if not self._tick_once():
                    self._stop.wait(self._tick)
        except Exception as exc:              # the device work's boundary: keep, hang up
            self._fail(exc)

    def _tick_once(self) -> bool:
        """One engine step and its sends -> whether it emitted anything."""
        with self._lock:
            out = self._eng.step()
            if self._transcribe:
                # Replace id frames with the UTF-8 transcript delta.
                deltas = {}
                for s in out:
                    text = self._eng.transcript(s)
                    deltas[s] = text[self._sent.get(s, 0):]
                    self._sent[s] = len(text)
                out = deltas
            done = [s for s in list(self._socks) if self._eng.is_done(s)]
            socks = {s: self._socks[s] for s in (*out, *done) if s in self._socks}
            for s in done:
                self._eng.close(s)
                self._socks.pop(s, None)
                if self._transcribe:
                    self._sent.pop(s, None)
        # Socket IO outside the lock: a slow client must not stall the
        # engine for everyone else beyond its own backlog.
        for s, payload in out.items():
            if s not in socks:
                continue
            try:
                if self._transcribe:
                    if payload:               # skip empty deltas
                        data = payload.encode("utf-8")
                        socks[s].sendall(_HDR.pack(len(data)) + data)
                else:
                    send_frame(socks[s], payload)
            except OSError:
                pass                          # client went away mid-stream
        for s in done:
            if s in socks:
                try:
                    send_eos(socks[s])
                except OSError:
                    pass
                socks[s].close()
        return bool(out)

    def _fail(self, exc: Exception) -> None:
        """The ticker failed: keep ``exc``, take no new session, and send
        every open session the end-of-stream frame before hanging up."""
        with self._lock:
            self._error = exc
            self._stop.set()
            socks = list(self._socks.values())
            self._socks.clear()
        _hang_up(self._srv)
        for sock in socks:
            try:
                send_eos(sock)
            except OSError:
                pass
            _hang_up(sock)


def _stream(address, samples: np.ndarray, push: int, receive,
            timeout: float | None) -> list:
    """Connect, push ``samples`` in frames of ``push`` from a writer thread
    (so the server's output drains while we push) and collect ``receive``'s
    frames until end-of-stream (or a socket timeout, which ends the frames
    as a hang-up does)."""
    sock = socket.create_connection(address, timeout=timeout)
    try:
        def _push():
            try:
                for i in range(0, len(samples), push):
                    send_frame(sock, samples[i: i + push])
                send_eos(sock)
            except OSError:
                pass                          # the server hung up: nothing more to send
        w = threading.Thread(target=_push, daemon=True)
        w.start()
        parts = []
        while (frame := receive(sock)) is not None:
            parts.append(frame)
        w.join(timeout=5.0)
    finally:
        sock.close()
    return parts


def enhance_via_server(address, samples: np.ndarray, push: int = 4000,
                       timeout: float | None = None) -> np.ndarray:
    """Client helper: stream a waveform to a running server, return the
    enhanced audio (blocks until the server's end-of-stream, or for at most
    ``timeout`` seconds a socket operation)."""
    outs = _stream(address, samples, push, recv_frame, timeout)
    return np.concatenate(outs) if outs else np.zeros(0, np.float32)


def transcribe_via_server(address, samples: np.ndarray, push: int = 4000,
                          timeout: float | None = None) -> str:
    """Client helper for a transcribe-mode server: stream a waveform, return
    the final transcript (concatenated UTF-8 deltas)."""
    return "".join(data.decode("utf-8")
                   for data in _stream(address, samples, push, recv_frame_bytes, timeout))
