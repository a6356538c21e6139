"""PTY name tables and EBU charset mapping.

Data semantics from src/rds/ebu-codetables.c (RDS/RBDS programme-type names,
EBU Latin table E.1 mapped to unicode).  Column 0 = Europe (RDS), column 1 =
USA (RBDS).
"""

PTY_TABLE = [
    ("--", "--"),
    ("News", "News"),
    ("Current Affairs", "Information"),
    ("Information", "Sports"),
    ("Sport", "Talk"),
    ("Education", "Rock"),
    ("Drama", "Classic Rock"),
    ("Culture", "Adult Hits"),
    ("Science", "Soft Rock"),
    ("Varied", "Top 40"),
    ("Pop Music", "Country"),
    ("Rock Music", "Oldies"),
    ("Easy Listening", "Soft"),
    ("Light Classical", "Nostalgia"),
    ("Serious Classical", "Jazz"),
    ("Other Music", "Classical"),
    ("Weather", "Rhythm & Blues"),
    ("Finance", "Soft Rhythm & Blues"),
    ("Children's Progs", "Language"),
    ("Social Affairs", "Religious Music"),
    ("Religion", "Religious Talk"),
    ("Phone-In", "Personality"),
    ("Travel", "Public"),
    ("Leisure", "College"),
    ("Jazz Music", "Spanish Talk"),
    ("Country Music", "Spanish Music"),
    ("National Music", "Hip Hop"),
    ("Oldies Music", "Unassigned"),
    ("Folk Music", "Unassigned"),
    ("Documentary", "Weather"),
    ("Alarm Test", "Emergency Test"),
    ("Alarm", "Emergency"),
]

# EBU Latin code table E.1: rows are the low nibble, columns the high nibble
# starting at 0x20 (columns 0-1 are control codes -> space).  'X' marks
# unassigned cells in the source table; we map those to space.
_EBU_E1 = [
    [' ', '0', '@', 'P', ' ', 'p', 'á', 'â', ' ', ' ', 'Á', 'Â', 'Ã', 'ã'],
    ['!', '1', 'A', 'Q', 'a', 'q', 'à', 'ä', 'α', '¹', 'À', 'Ä', 'Å', 'å'],
    ['"', '2', 'B', 'R', 'b', 'r', 'é', 'ê', '©', '²', 'É', 'Ê', 'Æ', 'æ'],
    ['#', '3', 'C', 'S', 'c', 's', 'è', 'ë', ' ', '³', 'È', 'Ë', 'Œ', 'œ'],
    [' ', '4', 'D', 'T', 'd', 't', 'í', 'î', ' ', ' ', 'Í', 'Î', 'Ŷ', 'ŵ'],
    ['%', '5', 'E', 'U', 'e', 'u', 'ì', 'ï', ' ', ' ', 'Ì', 'Ï', 'Ý', 'ý'],
    ['&', '6', 'F', 'V', 'f', 'v', 'ó', 'ô', ' ', ' ', 'Ó', 'Ô', 'Õ', 'õ'],
    ["'", '7', 'G', 'W', 'g', 'w', 'õ', 'ö', ' ', ' ', 'Ò', 'Ö', 'Ø', 'ø'],
    ['(', '8', 'H', 'X', 'h', 'x', 'ú', 'û', ' ', ' ', 'Ú', 'Û', ' ', ' '],
    [')', '9', 'I', 'Y', 'i', 'y', 'ù', 'ü', ' ', ' ', 'Ù', 'Ü', ' ', ' '],
    ['*', ':', 'J', 'Z', 'j', 'z', 'Ñ', 'ñ', '£', ' ', 'Ř', 'ř', 'Ŕ', 'ŕ'],
    ['+', ';', 'K', '[', 'k', '{', 'Ç', 'ç', '$', ' ', 'Č', 'č', 'Ć', 'ć'],
    [',', '<', 'L', '\\', 'l', ' ', 'Ş', 'ş', '←', '¼', 'Š', 'š', 'Ś', 'ś'],
    ['-', '=', 'M', ']', 'm', '}', 'β', 'ĝ', '↑', '½', 'Ž', 'ž', 'Ź', 'ź'],
    ['.', '>', 'N', ' ', 'n', ' ', ' ', ' ', '→', '¾', ' ', ' ', ' ', ' '],
    ['/', '?', 'O', ' ', 'o', ' ', 'Ĳ', 'ĳ', '↓', ' ', ' ', ' ', ' ', ' '],
]


def map_ebu_to_unicode(alphabet: int, character: int) -> str:
    col = (character & 0xF0) >> 4
    row = character & 0x0F
    if col < 2:
        return " "
    return _EBU_E1[row][col - 2]
