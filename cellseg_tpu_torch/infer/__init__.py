"""Sliding-window inference and the whole-image predictor of the port."""
