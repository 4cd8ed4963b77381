"""Host-side data sources (numpy only)."""
