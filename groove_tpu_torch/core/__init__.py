"""Core value types and musical time (copies of groove_tpu/core)."""
