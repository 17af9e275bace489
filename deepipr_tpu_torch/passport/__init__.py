"""Passport core: signature codec and passport -> affine derivation."""
