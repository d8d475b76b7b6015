"""Port of dev_scripts/ (see each module's docstring)."""
