"""Per-metric readers, found by name, and the yardstick they share."""
