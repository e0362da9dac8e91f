"""Closed-form operation and byte counts behind every mfu and roofline share."""
