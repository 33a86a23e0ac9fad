"""Dense transformer model code (the port's ``models`` layer)."""
