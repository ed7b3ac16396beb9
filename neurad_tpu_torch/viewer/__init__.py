"""Interactive browser viewer (self-contained HTTP, no viser dependency)."""

from neurad_tpu_torch.viewer.server import ViewerServer  # noqa: F401
