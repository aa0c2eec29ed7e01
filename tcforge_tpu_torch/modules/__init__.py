"""The port's module system.  Importing this package registers the
built-in filters, as importing ``tcforge_tpu.modules`` does."""

from tcforge_tpu_torch.modules.filters import (  # noqa: F401
    analysis, bob, cadence, denoise3d, dnr, extras, hqdn3d, median, modfps,
    msharpen, overlay, pp, rate, simple, smartdeinter, smooth, stabilize, tomsmocomp,
    unsharp, xsharpen, yait, yuvdenoise)
