"""Local runner: boot a SeldonDeployment graph in process."""
