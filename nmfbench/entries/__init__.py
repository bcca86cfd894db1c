"""Driver entries, one module a traffic ``entry``."""
