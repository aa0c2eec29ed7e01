"""The port's module system.  Importing this package registers the
built-in filters, as importing ``tcforge_tpu.modules`` does."""

from tcforge_tpu_torch.modules.filters import (  # noqa: F401
    bob, cadence, denoise3d, extras, hqdn3d, modfps, rate, simple,
    smartdeinter, tomsmocomp, unsharp)
