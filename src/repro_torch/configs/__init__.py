"""The paper's index configurations."""
