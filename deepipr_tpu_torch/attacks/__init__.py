"""Attack machinery (derived affines only in this slice)."""
