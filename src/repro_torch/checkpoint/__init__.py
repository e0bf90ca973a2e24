from .checkpoint import (PreemptionGuard, keyed_leaves, latest_step,
                         read_manifest, restore, row_dir, save)

__all__ = ["PreemptionGuard", "keyed_leaves", "latest_step", "read_manifest",
           "restore", "row_dir", "save"]
