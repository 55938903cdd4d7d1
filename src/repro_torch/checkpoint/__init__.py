from repro_torch.checkpoint.checkpoint import (flatten_tree,  # noqa: F401
                                               load, manifest, restore,
                                               save)
