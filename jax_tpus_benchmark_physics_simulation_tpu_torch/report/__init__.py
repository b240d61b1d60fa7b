"""Result export (CSV); the plots, JSON and WAV outputs are not ported yet."""
