"""Parallel attention (single-device for now; ring attention is ROADMAP Queue 1 #9)."""
