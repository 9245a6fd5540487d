"""Architecture configs (pure data, copied from the reference's
``configs/``) and their registry."""
