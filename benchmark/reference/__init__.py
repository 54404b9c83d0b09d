"""The plain references: ``reference/<config>.py`` beside ``common.py``."""
