"""The plain reference the check holds the program against (`stft64`)."""
