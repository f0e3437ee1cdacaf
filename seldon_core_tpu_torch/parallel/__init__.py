"""Single-device pieces of the reference's parallel package."""
