"""A stream's compressed audio decoded away from the demux.

The MPEG importer's demux runs on the engine's reader thread, beside the
host parse of the video.  The in-tree AC-3 and MPEG audio decoders
(``io/a52dec.py``, ``io/mp2dec.py`` with ``io/mp3dec.py``) are pure
Python: decoded inline, as the JAX importer does, they would hold the
reader thread for longer than the parse itself, and in a thread they
would hold the interpreter lock that the parse's Python half and the
engine's threads need.  So the demux hands each payload, in demux
order, to a ``Decoder``: one ``StreamDecoder`` of the JAX importer's
kind in a child Python process (``python -m
tcforge_tpu_torch.io.adec_worker``), which imports numpy and the
decoder alone, reads pickled requests on its standard input and writes
pickled results on its standard output, in the same order.  A thread of
the parent reads those results into a queue as they arrive, so the
child never waits on a full pipe, however far the demux runs ahead of
the results it takes.

A request is ``feed`` (a payload: ``StreamDecoder.feed`` then ``read``)
or ``flush`` (``flush`` then ``read``), or ``reset`` (a fresh decoder:
a process whose decoder closed serves the next one of its kind, so that
a title's VOB files do not start one each); its result is ``(pcm,
rate)``: the samples that the decoder gave back, (S, C) int16 or None,
and the decoder's rate after it; ``decode_seconds`` sums the decoders'
own time over the results taken.  A decoder that raises hands its error,
with the samples it gave back before it, to the caller of ``result``,
which raises it there (``outcome`` returns both).
"""

from __future__ import annotations

import atexit
import os
import pickle
import queue
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent


class AdtsStreamDecoder:
    """ADTS AAC in the shape of the other stream decoders (``feed``,
    ``flush``, ``read``, ``rate``, ``channels``) over ``io/aacdec.py``:
    each whole frame decodes as it arrives, with the resync, the frames
    skipped and the rounding of ``decode_adts_stream``, so the samples
    of a stream fed in any pieces are that function's on the whole
    stream; a stream with no decodable frame raises its error at
    ``flush``."""

    def __init__(self):
        from tcforge_tpu_torch.io.aacdec import AacDecoder
        self._dec = AacDecoder()
        self._buf = b""
        self._out: List[np.ndarray] = []
        self._frames = 0
        self.rate = 0
        self.channels = 0

    def feed(self, data: bytes) -> None:
        self._buf += data
        self._drain(final=False)

    def flush(self) -> None:
        self._drain(final=True)
        if not self._frames:
            raise ValueError("aac: no decodable ADTS frames")

    def _drain(self, final: bool) -> None:
        from tcforge_tpu_torch.io.aacdec import parse_adts_header
        buf, pos, n = self._buf, 0, len(self._buf)
        while pos + 7 <= n:
            h = parse_adts_header(buf[pos:pos + 9])
            if h is None:
                pos += 1
                continue
            if pos + h["frame_length"] > n:
                if not final:
                    break                # the rest of the frame to come
                pos += 1
                continue
            if h["profile"] != 1:        # 1 = LC in ADTS coding
                raise NotImplementedError(
                    f"aac: ADTS profile {h['profile']} (only LC)")
            payload = buf[pos + h["header_bytes"]:pos + h["frame_length"]]
            try:
                pcm = self._dec.decode_raw(payload, h["sfi"],
                                           h["channels"])
            except (ValueError, EOFError):
                pos += 1
                continue
            if not self._frames:
                self.channels = pcm.shape[1]
            self._frames += 1
            self.rate = self._dec.sample_rate
            self._out.append(np.clip(np.rint(pcm), -32768,
                                     32767).astype(np.int16))
            pos += h["frame_length"]
        self._buf = buf[pos:]

    def read(self) -> Optional[np.ndarray]:
        if not self._out:
            return None
        out = (self._out[0] if len(self._out) == 1
               else np.concatenate(self._out))
        self._out = []
        return out


def new_stream_decoder(kind: str):
    """The in-tree decoder for ``kind``: the JAX importers' fallback
    decoder (``ac3``; ``mp2`` and ``mp3``, one ``StreamDecoder`` that
    hands Layer III frames to ``io/mp3dec.py``), or ``aac``, ADTS frames
    through ``io/aacdec.py``."""
    if kind == "ac3":
        from tcforge_tpu_torch.io.a52dec import StreamDecoder
        return StreamDecoder()
    if kind in ("mp2", "mp3"):
        from tcforge_tpu_torch.io.mp2dec import StreamDecoder
        return StreamDecoder()
    if kind == "aac":
        return AdtsStreamDecoder()
    raise ValueError(f"no audio decoder for {kind!r}")


def _run(dec, op: str, data: bytes):
    t0 = time.perf_counter()
    if op == "feed":
        dec.feed(data)
    else:
        dec.flush()
    return dec.read(), dec.rate, time.perf_counter() - t0


# the decoders' own time over every result taken in this process
_SECONDS = [0.0]


def decode_seconds() -> float:
    """The decoders' own time, in seconds, summed over every result
    taken so far in this process."""
    return _SECONDS[0]


class _Worker:
    """A child process serving one decoder at a time, and the thread
    that moves its results into ``out`` as they arrive (None once its
    output ends)."""

    def __init__(self, kind: str):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(_ROOT)] + ([env["PYTHONPATH"]]
                            if env.get("PYTHONPATH") else []))
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "tcforge_tpu_torch.io.adec_worker", kind],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env,
            cwd=str(_ROOT))
        self.out: "queue.Queue" = queue.Queue()
        self._reader = threading.Thread(target=self._read,
                                        name="tcforge-adec-results",
                                        daemon=True)
        self._reader.start()

    def _read(self) -> None:
        while True:
            try:
                got = _recv(self.proc.stdout)
            except (OSError, ValueError, EOFError, pickle.UnpicklingError):
                got = None
            self.out.put(got)
            if got is None:
                return

    def send(self, op: str, data: bytes) -> None:
        _send(self.proc.stdin, (op, data))

    def take(self):
        """The oldest result not taken, waiting for it."""
        got = self.out.get()
        if got is None:
            self.out.put(None)          # every later take sees the end
            raise RuntimeError("the audio decode process ended "
                               f"(exit code {self.proc.poll()})")
        return got

    def stop(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self._reader.join(timeout=10)
        self.proc.stdout.close()


# worker processes whose decoder has closed, by kind: the next decoder of
# that kind takes one and resets it (a title's VOB files each open a
# decoder); stopped when the interpreter exits
_IDLE: Dict[str, List[_Worker]] = {}
_IDLE_LOCK = threading.Lock()


@atexit.register
def stop_idle_workers() -> None:
    """Stop every idle worker process."""
    with _IDLE_LOCK:
        workers = [w for ws in _IDLE.values() for w in ws]
        _IDLE.clear()
    for worker in workers:
        worker.stop()


class Decoder:
    """One stream decoder of ``kind`` in a worker process: requests in
    order with ``submit``, their results in the same order with
    ``result``."""

    def __init__(self, kind: str):
        self.kind = kind
        self.pending = 0              # submitted, result not taken yet
        with _IDLE_LOCK:
            idle = _IDLE.get(kind, [])
            self._worker = idle.pop() if idle else None
        if self._worker is not None:
            self.submit("reset")
            self.result()
        else:
            self._worker = _Worker(kind)

    def submit(self, op: str, data: bytes = b"") -> None:
        self.pending += 1
        self._worker.send(op, data)

    def result(self) -> Tuple[Optional[np.ndarray], int]:
        """The oldest request's ``(pcm, rate)``, waiting for it."""
        pcm, rate, error = self.outcome()
        if error is not None:
            raise error
        return pcm, rate

    def outcome(self) -> Tuple[Optional[np.ndarray], int,
                               Optional[BaseException]]:
        """The oldest request's ``(pcm, rate, error)``, waiting for it:
        ``error`` is what the decoder raised on it (then pcm holds the
        samples it gave back before that, or None), else None.  A worker
        process that ended raises."""
        if self.pending <= 0:
            raise RuntimeError("no audio decode request is pending")
        self.pending -= 1
        ok, value = self._worker.take()
        if not ok:
            error, pcm, rate = value
            return pcm, rate, error
        pcm, rate, seconds = value
        _SECONDS[0] += seconds
        return pcm, rate, None

    def close(self) -> None:
        """Drop the results not taken; the worker, once it answered them
        all, waits idle for the next decoder of its kind."""
        if self._worker is None:
            return
        worker, self._worker = self._worker, None
        try:
            while self.pending:
                self.pending -= 1
                worker.take()
        except RuntimeError:             # the process ended: not reused
            worker.stop()
            return
        with _IDLE_LOCK:
            _IDLE.setdefault(self.kind, []).append(worker)


class SampleFifo:
    """Decoded samples in order, taken from the front."""

    def __init__(self):
        self.fifo: List[np.ndarray] = []
        self.have = 0                    # samples in the fifo

    def put(self, pcm: np.ndarray) -> None:
        self.fifo.append(pcm)
        self.have += pcm.shape[0]

    def take(self, n: int) -> Optional[np.ndarray]:
        """Up to ``n`` samples from the front, or None when none waits."""
        if not self.fifo:
            return None
        cat = (self.fifo[0] if len(self.fifo) == 1
               else np.concatenate(self.fifo))
        take, rest = cat[:n], cat[n:]
        self.fifo = [rest] if rest.shape[0] else []
        self.have = rest.shape[0]
        return take if take.shape[0] else None


class StreamSamples(SampleFifo):
    """A stream of ``kind`` decoded in a worker process a few pieces
    ahead of the samples taken: ``pieces`` (bytes) go to a ``Decoder``
    at most ``ahead`` requests ahead of the results taken, then a flush;
    ``rate`` and ``channels`` are the first decoded frame's."""

    def __init__(self, kind: str, pieces, ahead: int = 4):
        super().__init__()
        self.dec = Decoder(kind)
        self.pieces = pieces
        self.ahead = ahead
        self.fed = False
        self.rate = 0
        self.channels = 0

    def fill(self, n: int, errors: bool = False
             ) -> Optional[BaseException]:
        """Take results until ``n`` samples wait or none is left.  An
        error of the decoder, once the samples decoded before it wait,
        raises, or with ``errors`` is returned; a worker process that
        ended raises."""
        while self.have < n:
            while self.dec.pending < self.ahead and not self.fed:
                piece = next(self.pieces, None)
                if piece is None:
                    self.dec.submit("flush")
                    self.fed = True
                else:
                    self.dec.submit("feed", piece)
            if not self.dec.pending:
                break
            pcm, rate, error = self.dec.outcome()
            if pcm is not None and len(pcm):
                if not self.rate:
                    self.rate, self.channels = rate, pcm.shape[1]
                self.put(pcm)
            if error is not None:
                if errors:
                    return error
                raise error
        return None

    def close(self) -> None:
        if self.dec is not None:
            self.dec.close()
            self.dec = None


def _send(f, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _recv(f):
    head = f.read(8)
    if len(head) < 8:
        return None
    size = struct.unpack("<Q", head)[0]
    return pickle.loads(f.read(size))


def serve(kind: str) -> int:
    """The worker process: requests from standard input, results to
    standard output, until standard input closes."""
    rd, wr = sys.stdin.buffer, sys.stdout.buffer
    dec = new_stream_decoder(kind)
    while True:
        item = _recv(rd)
        if item is None:
            return 0
        try:
            if item[0] == "reset":     # the next stream: a new decoder
                dec = new_stream_decoder(kind)
                out = (True, (None, 0, 0.0))
            else:
                out = (True, _run(dec, *item))
        except Exception as e:
            out = (False, (e, dec.read(), dec.rate))
        _send(wr, out)


if __name__ == "__main__":
    sys.exit(serve(sys.argv[1]))
