"""Host-side lowering shared with the device plans (no host matcher here)."""
