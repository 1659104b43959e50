"""Measuring scripts of the port; nothing on a path imports them."""
