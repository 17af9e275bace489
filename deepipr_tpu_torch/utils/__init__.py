"""Host-side helpers: passport-config expansion, device and mode selection."""
