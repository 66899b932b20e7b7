from .adamw import (AdamWState, adamw_init, adamw_update, cosine_schedule,
                    tree_leaves, tree_map, wsd_schedule)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_schedule",
           "wsd_schedule", "tree_leaves", "tree_map"]
