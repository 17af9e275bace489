"""Host-side helpers: passport-config expansion and device selection."""
