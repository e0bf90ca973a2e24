from .checkpoint import (PreemptionGuard, keyed_leaves, latest_step,
                         read_manifest, restore, save)

__all__ = ["PreemptionGuard", "keyed_leaves", "latest_step", "read_manifest",
           "restore", "save"]
