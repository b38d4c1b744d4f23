"""The training step (one device; several cards are queued in ROADMAP.md)."""
