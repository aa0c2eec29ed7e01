"""The ``vorbis`` encoder (``tcforge_tpu/modules/encoders/vorbis_enc.py``,
encode_vorbis.c's role).

It wraps the pinned copy of the JAX package's in-tree Vorbis I coder
(``io/vorbisenc.py``, float64 numpy: the MDCT, the floor and the
residue run in the source's order, so the packets are its bytes).  PCM
batches in, one Vorbis packet a block out; the three header packets go
to the multiplexor through ``job.extradata`` (``vorbis_headers``, with
the hop in ``vorbis_hop``), and the flush leaves the true sample count
in ``vorbis_total_samples`` for the last page's granule.
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from tcforge_tpu_torch.core.codecs import Codec
from tcforge_tpu_torch.core.frame import AudioBatch
from tcforge_tpu_torch.core.optstr import ModuleDesc, ParamSpec
from tcforge_tpu_torch.modules.registry import (Encoder, ModuleInfo,
                                                ModuleKind, register)


def pack_header_packets(pkts: List[bytes]) -> bytes:
    """Length-prefixed concatenation (extradata is a flat bytes map)."""
    return b"".join(struct.pack("<I", len(p)) + p for p in pkts)


def unpack_header_packets(blob: bytes) -> List[bytes]:
    out = []
    pos = 0
    while pos + 4 <= len(blob):
        (ln,) = struct.unpack("<I", blob[pos:pos + 4])
        out.append(blob[pos + 4:pos + 4 + ln])
        pos += 4 + ln
    return out


@register
class VorbisAudioEncoder(Encoder):
    info = ModuleInfo(name="vorbis", kind=ModuleKind.ENCODER,
                      media="audio", codecs_in=(Codec.PCM,),
                      codecs_out=(Codec.VORBIS,))
    desc = ModuleDesc(
        name="vorbis", comment="Vorbis I audio encoder (in-tree "
        "flat-floor/lattice-residue coder; mux with 'ogg')",
        params=[ParamSpec("blocksize", "block size (power of two)",
                          "d", 2048, 64, 8192),
                ParamSpec("delta", "base quantizer step "
                          "(>= 0.09; halving adds ~6 dB)",
                          "f", 0.125),
                ParamSpec("passes", "residue refinement passes "
                          "(~12 dB SNR each, ~+20% bitrate)",
                          "d", 5, 2, 7)])

    def __init__(self, job, options: str = ""):
        super().__init__(job, options)
        from tcforge_tpu_torch.io.vorbisenc import VorbisEncoder
        rate = job.mp3frequency or job.a_rate
        ch = job.dm_chan or job.a_chan
        self._n = int(self.options["blocksize"])
        if self._n & (self._n - 1):
            raise ValueError(
                f"vorbis: blocksize {self._n} is not a power of two "
                "(the ident header stores log2 exponents)")
        self._hop = self._n // 2
        self._enc = VorbisEncoder(rate, ch, blocksize=self._n,
                                  base_delta=float(self.options["delta"]),
                                  passes=int(self.options["passes"]))
        job.extradata["vorbis_headers"] = pack_header_packets(
            self._enc.header_packets())
        job.extradata["vorbis_hop"] = struct.pack("<I", self._hop)
        # the lapping carry starts as half a block of silence (the
        # decoder drops its first output block alike)
        self._buf = np.zeros((self._hop, ch), np.float64)
        self._in_samples = 0           # the true length, for the granule

    def encode_video(self, fb) -> List[bytes]:
        raise NotImplementedError("vorbis is an audio-only encoder")

    def encode_audio(self, ab: AudioBatch) -> List[bytes]:
        pcm = np.asarray(ab.pcm)
        x = pcm.reshape(-1, pcm.shape[-1]).astype(np.float64) / 32768.0
        self._in_samples += x.shape[0]
        self._buf = np.concatenate([self._buf, x], axis=0)
        out: List[bytes] = []
        while self._buf.shape[0] >= self._n:
            out.append(self._enc.encode_block(self._buf[:self._n]))
            self._buf = self._buf[self._hop:]
        return out

    def flush(self) -> List[bytes]:
        if self._buf.shape[0] <= self._hop:
            tail_needed = self._n - self._buf.shape[0]
        else:
            tail_needed = 2 * self._n - self._buf.shape[0]
        pad = np.zeros((tail_needed, self._buf.shape[1]))
        self._buf = np.concatenate([self._buf, pad], axis=0)
        out: List[bytes] = []
        while self._buf.shape[0] >= self._n:
            out.append(self._enc.encode_block(self._buf[:self._n]))
            self._buf = self._buf[self._hop:]
        self.last_flush_frames = 0
        # the multiplexor clamps the last page's granule to it
        self.job.extradata["vorbis_total_samples"] = struct.pack(
            "<Q", self._in_samples)
        return out
