"""Models: ResNet family with passport and private-passport blocks."""
