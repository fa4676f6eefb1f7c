"""Datasets of the port: directory conventions and shape loading."""
