"""AGE kernel: event-driven gather + segment reduce over edge tiles."""
