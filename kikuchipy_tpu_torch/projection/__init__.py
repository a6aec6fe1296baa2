"""Master-pattern projection."""
