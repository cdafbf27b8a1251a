"""Architecture configs of the port. Importing this package registers
them with the config registry (``repro_torch.config.get_arch``)."""

from repro_torch.configs import llama3_2_1b, mamba2_370m  # noqa: F401
