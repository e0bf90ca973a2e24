from .checkpoint import latest_step, read_manifest, restore, save

__all__ = ["latest_step", "read_manifest", "restore", "save"]
