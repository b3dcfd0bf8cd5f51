"""The float32 reference that judges the timed path; imports nothing of the program."""
