"""Host-side data fixtures of the port (numpy only)."""
