"""Host visualization of the port (numpy; no PIL): overlays and the demo CLI."""
