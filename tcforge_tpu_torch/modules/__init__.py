"""The port's module system.  Importing this package registers the
built-in filters, as importing ``tcforge_tpu.modules`` does."""

from tcforge_tpu_torch.modules.filters import hqdn3d  # noqa: F401
