"""Result analysis and reports (`analyzer.py`)."""
