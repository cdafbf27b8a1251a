"""Architecture configs of the port. Importing this package registers
them with the config registry (``repro_torch.config.get_arch``); the TCMM
app's config is not an architecture and stays outside it."""

from repro_torch.configs import llama3_2_1b, mamba2_370m  # noqa: F401
from repro_torch.configs.tcmm import TCMMConfig  # noqa: F401
