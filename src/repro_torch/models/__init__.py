"""Dense decoder: layers, tree attention, transformer assembly."""
