"""Evaluation: image metrics, LPIPS, pixel tracking and whole sequences."""
