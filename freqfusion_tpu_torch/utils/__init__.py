"""Host utilities (image IO)."""
