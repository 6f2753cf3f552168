"""Levenberg-Marquardt driver."""
