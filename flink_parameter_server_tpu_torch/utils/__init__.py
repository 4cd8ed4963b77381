"""Device selection and per-id initializers."""
