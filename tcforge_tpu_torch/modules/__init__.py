"""The port's module system.  Importing this package registers the
built-in filters, the WAV, MP3, AC-3, FLAC, AAC, AU, VAG, null, MPEG,
AVI, MOV, Ogg, DV, NuppelVideo and framegen importers, the WAV, Y4M,
AVI, raw, null, mpg, mov, ogg, dv and nuv multiplexors and the raw,
null, copy, yuv4mpeg, mpeg2, lzo, xvid, movjpeg, lame, mp2enc, ac3enc,
faac, flac, vorbis, dv, nuvrtj and theora encoders, as importing
``tcforge_tpu.modules`` does."""

from tcforge_tpu_torch.modules.encoders import audio_enc  # noqa: F401
from tcforge_tpu_torch.modules.encoders import basic as _encoders  # noqa: F401
from tcforge_tpu_torch.modules.encoders import capture_enc  # noqa: F401
from tcforge_tpu_torch.modules.encoders import image_enc  # noqa: F401
from tcforge_tpu_torch.modules.encoders import lzo_enc  # noqa: F401
from tcforge_tpu_torch.modules.encoders import movjpeg  # noqa: F401
from tcforge_tpu_torch.modules.encoders import mpeg2  # noqa: F401
from tcforge_tpu_torch.modules.encoders import theora_enc  # noqa: F401
from tcforge_tpu_torch.modules.encoders import vorbis_enc  # noqa: F401
from tcforge_tpu_torch.modules.encoders import xvid  # noqa: F401
from tcforge_tpu_torch.modules.importers import audio_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import avi_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import framegen  # noqa: F401
from tcforge_tpu_torch.modules.importers import dv_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import dvd_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import mov_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import mpeg_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import multi  # noqa: F401
from tcforge_tpu_torch.modules.importers import nuv_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import ogg_import  # noqa: F401
from tcforge_tpu_torch.modules.importers import wav_import  # noqa: F401
from tcforge_tpu_torch.modules.muxers import basic as _muxers  # noqa: F401
from tcforge_tpu_torch.modules.muxers import capture_mux  # noqa: F401
from tcforge_tpu_torch.modules.muxers import mov_mux  # noqa: F401
from tcforge_tpu_torch.modules.muxers import ogg_mux  # noqa: F401
from tcforge_tpu_torch.modules.muxers import ps_mux  # noqa: F401

from tcforge_tpu_torch.modules.filters import (  # noqa: F401
    analysis, audio_filters, bob, cadence, denoise3d, dnr, extras, extsub, hqdn3d, median,
    modfps,
    msharpen, overlay, pp, rate, simple, smartdeinter, smooth, stabilize, tomsmocomp,
    unsharp, xsharpen, yait, yuvdenoise)
