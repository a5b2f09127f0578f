"""Sharding policy, ambient constraints and step statistics over a DeviceMesh."""
