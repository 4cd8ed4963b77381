"""Worker logics."""
