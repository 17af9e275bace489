"""Passport core: signature codec, passport -> affine derivation, sign loss."""
