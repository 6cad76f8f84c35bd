"""Greedy generation and sliding-window inference."""
