"""int8-resident serving of the port."""
