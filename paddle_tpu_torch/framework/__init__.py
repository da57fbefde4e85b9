"""Framework services of the port: seeding and device choice."""
