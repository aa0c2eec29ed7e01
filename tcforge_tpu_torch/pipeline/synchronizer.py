"""A/V synchronizer: drop/clone video to hold sync against the audio
master.

Rebuild of ``src/synchronizer.c``: the synchronizer sits between the
demuxer and the frame ring.  Two methods:

- ``none`` (tc_sync_none_init, synchronizer.c:120-150): pass frames
  through, applying only the initial ``-D`` audio shift;
- ``adjust`` (tc_sync_adjust_*, synchronizer.c:160-330): track video vs
  audio frame counters; every ``frames_interval`` video frames, when the
  drift exceeds ``frames_margin``, schedule one fixup — audio ahead
  clones the last video frame, video ahead drops the next one.  Audio is
  the master source (the only mode the reference supports).

The ``-D`` audio shift (tc_sync_audio_shift, synchronizer.c:95-118):
negative inserts that many silent audio frames up front, positive drops
that many audio frames at stream start.

This is host-side IO bookkeeping over numpy batches — it runs in the
reader thread before frames are uploaded, exactly where the reference
hooks its synchronizer into the import loop (decoder.c:459-545).

The port of ``tcforge_tpu/pipeline/synchronizer.py``: the same code,
logging through the port's logger.
"""

from __future__ import annotations

from typing import Dict, Optional

import logging

import numpy as np

_log = logging.getLogger("tcforge_tpu_torch")


class Synchronizer:
    """`none` method + the common -D audio shift."""

    method = "none"

    def __init__(self, audio_shift: int = 0, fine_samples: int = 0):
        self.audio_shift = audio_shift
        self.fine_samples = fine_samples   # --av_fine_ms sub-frame shift
        self.video_cloned = 0
        self.video_dropped = 0

    # -- audio ----------------------------------------------------------

    def process_audio(self, pcm: Optional[np.ndarray],
                      spf: int) -> Optional[np.ndarray]:
        """Apply the pending -D shift (whole audio frames) and the
        --av_fine_ms sub-frame sample shift to an (S, C) block."""
        if pcm is not None and self.fine_samples:
            if self.fine_samples < 0:
                pad = np.zeros((-self.fine_samples, pcm.shape[1]),
                               pcm.dtype)
                pcm = np.concatenate([pad, pcm], axis=0)
                self.fine_samples = 0
            else:
                take = min(self.fine_samples, pcm.shape[0])
                self.fine_samples -= take
                pcm = pcm[take:]
        if pcm is None or self.audio_shift == 0 or spf <= 0:
            return pcm
        if self.audio_shift < 0:
            # insert silence (blank audio frames)
            n = -self.audio_shift
            self.audio_shift = 0
            pad = np.zeros((n * spf, pcm.shape[1]), pcm.dtype)
            return np.concatenate([pad, pcm], axis=0)
        # drop leading audio frames
        take = min(self.audio_shift, pcm.shape[0] // spf)
        self.audio_shift -= take
        return pcm[take * spf:]

    # -- video ----------------------------------------------------------

    def process_video(self, planes: Dict[str, np.ndarray],
                      audio_frames: int) -> Dict[str, np.ndarray]:
        return planes

    def summary(self) -> str:
        return (f"({self.method}) video frames cloned/dropped: "
                f"{self.video_cloned}/{self.video_dropped}")


class AdjustSynchronizer(Synchronizer):
    """`adjust` method: audio-master drift correction by frame
    clone/drop (synchronizer.c:221-257)."""

    method = "adjust"

    def __init__(self, audio_shift: int = 0, frames_margin: int = 1,
                 frames_interval: int = 25):
        super().__init__(audio_shift)
        self.frames_margin = frames_margin
        self.frames_interval = frames_interval
        self.video_counter = 0
        self.audio_counter = 0
        self._op = 0          # 0 none, 1 clone, -1 drop
        self._saved: Optional[Dict[str, np.ndarray]] = None

    def process_video(self, planes: Dict[str, np.ndarray],
                      audio_frames: int) -> Dict[str, np.ndarray]:
        n = next(iter(planes.values())).shape[0]
        keys = list(planes.keys())
        # interleave the audio credit across the batch the way the C's
        # per-frame get_audio/get_video alternation would
        base_ac = self.audio_counter
        # per output slot: source index, or the saved clone dict.
        # video_counter counts OUTPUT frames, exactly like the
        # reference (tc_sync_adjust_get_video increments per emitted
        # frame: a clone emits WITHOUT consuming source, so vc
        # catches up to ac and the fixups stop — counting source
        # frames instead would re-trigger a fixup every interval
        # forever, manufacturing drift)
        picks = []
        i = 0
        while i < n:
            self.audio_counter = base_ac + round(
                audio_frames * (i + 1) / max(1, n))
            if self._op == 1 and self._saved is not None:
                self._op = 0
                picks.append(self._saved)  # emit clone, consume none
                self.video_cloned += 1
                self._check(planes, i)
                continue
            if self._op == -1:
                self._op = 0
                self.video_dropped += 1
                i += 1                    # discard this source frame
                continue
            self._op = 0
            picks.append(i)
            self._check(planes, i)
            i += 1
        self.audio_counter = base_ac + audio_frames

        if len(picks) == n and all(
                isinstance(p, int) and p == k
                for k, p in enumerate(picks)):
            return planes
        out = {}
        for k in keys:
            rows = [p[k] if isinstance(p, dict) else planes[k][p]
                    for p in picks]
            out[k] = np.stack(rows) if rows else planes[k][:0]
        return out

    def _check(self, planes: Dict[str, np.ndarray], i: int) -> None:
        """Post-emission drift check, then the output-frame counter
        increment — the reference's order (synchronizer.c:240-257:
        schedule the op for the NEXT emission using the pre-increment
        counter; unlike the reference, the clone/drop tallies count
        at EXECUTION so the summary never includes an op still
        pending at EOS)."""
        vc, ac = self.video_counter, self.audio_counter
        if self.frames_margin != 0 and vc and ac \
                and (self.frames_interval == 0
                     or vc % self.frames_interval == 0):
            if abs(ac - vc) > self.frames_margin:
                if ac > vc:
                    self._saved = {k: np.array(v[i])
                                   for k, v in planes.items()}
                    self._op = 1
                    _log.info("[sync] (adjust) clone at frame %d "
                              "(A/V %d/%d)", vc, ac, vc)
                else:
                    self._op = -1
                    _log.info("[sync] (adjust) drop at frame %d "
                              "(A/V %d/%d)", vc, ac, vc)
        self.video_counter += 1


def new_synchronizer(job) -> Synchronizer:
    """tc_sync_init analogue: method from job.sync_method."""
    shift = job.av_offset
    fine = 0
    ms = getattr(job, "av_fine_ms", 0)
    if ms:
        # the shift applies to SOURCE-rate PCM (process_audio slices
        # importer blocks before any -E resample), so the sample
        # count must use the input rate: sync_ms * a_rate / 1000
        # (audio_trans.c:74) — the output rate would shift by the
        # wrong duration whenever -E is active
        rate = job.a_rate or job.mp3frequency or 48000
        fine = int(round(ms * rate / 1000.0))
    if job.sync_method == "adjust":
        s = AdjustSynchronizer(
            audio_shift=shift,
            frames_margin=getattr(job, "resync_margin", 1),
            frames_interval=getattr(job, "resync_interval", 25))
        s.fine_samples = fine
        return s
    return Synchronizer(audio_shift=shift, fine_samples=fine)
