"""Serving: DecodeSession (prefill/fork/step/snapshot) and rollout groups."""
