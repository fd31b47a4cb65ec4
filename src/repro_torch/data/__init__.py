"""Copies of the reference's synthetic tree generators."""
