"""The benchmark's own input generators: every input a run hands the program
is drawn here from the run's seed."""
