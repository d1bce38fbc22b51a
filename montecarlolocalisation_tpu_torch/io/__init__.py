"""Online serving."""
